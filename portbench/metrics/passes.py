"""Mean number of device passes a request issues: the program's
``lz4t.*.pass`` spans that start in it (torch.profiler).  A write cell
holds only encode passes."""

from portbench.phases import count


def read(ctx):
    return count(ctx, "pass")
