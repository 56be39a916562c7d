"""Bytes written over bytes given, over every request of the window."""


def read(ctx):
    given = sum(w[0] for w in ctx.work)
    return sum(w[1] for w in ctx.work) / given if given else None
