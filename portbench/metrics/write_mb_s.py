"""Input bytes compressed a second, the output on the host, in 10**6
bytes: all the window's requests over the window's host-clock time."""


def read(ctx):
    return sum(w[0] for w in ctx.work) / ctx.window_s / 1e6
