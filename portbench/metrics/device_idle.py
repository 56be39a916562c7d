"""Percent of the traced window with no kernel, copy or set on the
device (torch.profiler; busy time averaged over the ranks)."""

from portbench.metrics_ctx import device_idle


def read(ctx):
    return device_idle(ctx)
