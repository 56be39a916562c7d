"""Percent of rank 0's request time in which an NCCL kernel ran on its
device (torch.profiler's device trace: the union of the collectives'
kernels inside each request).  A collective's kernel starts when its rank
reaches it and ends when every rank has, so this counts the exchange and
the wait for the slowest rank behind it."""

from portbench.trace import Covered, merge


def read(ctx):
    t = ctx.trace
    if t is None or not t.requests:
        return None
    nccl = [(a, b) for name, a, b in t.device
            if name.lower().startswith("nccl")]
    if not nccl:
        return None
    covered = Covered(merge(nccl))
    total = sum(b - a for a, b in t.requests)
    return 100.0 * sum(covered.within(a, b) for a, b in t.requests) / total
