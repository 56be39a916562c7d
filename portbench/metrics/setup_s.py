"""Set-up seconds: from the process's start (imports, the CUDA context,
the kernels' library, the AutoTest, the seed's inputs) to the window's
start, the cell's shapes warmed (host clock)."""


def read(ctx):
    return ctx.setup_s
