"""The 95th percentile of every request's latency in the window, in ms
(host clock, from the call to the answer on the host)."""

from portbench.metrics_ctx import percentile


def read(ctx):
    return 1e3 * percentile(ctx.latencies, 95) if ctx.latencies else None
