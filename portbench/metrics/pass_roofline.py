"""Percent of the device's busy time that the window's requests need at
the peak bandwidth (portbench/peaks.json): each request's input read
once and its output written once, whatever kernels do the work."""

from portbench.metrics_ctx import window_roofline


def read(ctx):
    return window_roofline(ctx)
