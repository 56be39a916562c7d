"""Mean ms a request spends with the device idle inside the program's
window spans (``lz4t.encode.window``: P-mode window rows laid out on the
host, within ``lz4t.encode.layout``; torch.profiler).  None where the
trace holds no such span: an untraced run, a batch without a
dictionary, or a program without the span."""

from portbench.metrics_ctx import traced_device
from portbench.phases import idle_in_requests

SPAN = "lz4t.encode.window"


def read(ctx):
    if not traced_device(ctx) or not ctx.trace.requests:
        return None
    spans = [(a, b) for name, a, b in ctx.trace.host if name == SPAN]
    if not spans:
        return None
    idle = idle_in_requests(ctx.trace, spans)
    return 1e3 * sum(idle) / len(idle)
