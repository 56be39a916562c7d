"""Decoded bytes delivered to the host a second, in 10**6 bytes: all the
window's answers over the window's host-clock time."""


def read(ctx):
    return sum(w[1] for w in ctx.work) / ctx.window_s / 1e6
