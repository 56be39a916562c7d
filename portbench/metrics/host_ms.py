"""Mean ms of a request's host-clock span in which the device was idle
(the span less the device busy time inside it; torch.profiler)."""

from portbench.metrics_ctx import host_ms


def read(ctx):
    return host_ms(ctx)
