"""The program's phase spans in a traced run, and the device's idle time
inside them.

The port marks each host phase of a call with a span of its own
(``lz4net_tpu_torch/spans.py``), on the clock of the trace's kernels and
copies: ``lz4t.<side>.<phase>``, the phase one of ``PHASES``.  Phase
spans are leaves; the roots that enclose them (``lz4t.encode.batch``,
``lz4t.stream.chunk``, ...) are not read here.  Every reader returns
None where the trace holds no ``lz4t.`` span: an untraced run, or a
program without the spans.
"""

from __future__ import annotations

import bisect

from portbench import metrics_ctx
from portbench.trace import Covered, merge

PREFIX = "lz4t."
PHASES = ("layout", "upload", "pass", "fetch", "unpack", "frame")


def phase(name: str) -> str | None:
    """The phase of a program span's name, None for a root or another
    span."""
    if not name.startswith(PREFIX):
        return None
    last = name.rsplit(".", 1)[1]
    return last if last in PHASES else None


def _readable(ctx) -> bool:
    return (metrics_ctx.traced_device(ctx) and bool(ctx.trace.requests)
            and any(n.startswith(PREFIX) for n, _, _ in ctx.trace.host))


def idle_in_requests(t, intervals) -> list[float]:
    """Seconds, for each request of the window, in which the device was
    idle inside the union of ``intervals`` cut to the request."""
    union = merge(intervals)
    starts = [a for a, _ in union]
    ends = [b for _, b in union]
    busy = Covered(t.busy())
    out = []
    for ra, rb in t.requests:
        idle = 0.0
        for k in range(bisect.bisect_right(ends, ra),
                       bisect.bisect_left(starts, rb)):
            a, b = max(starts[k], ra), min(ends[k], rb)
            idle += (b - a) - busy.within(a, b)
        out.append(idle)
    return out


def _phase_spans(t, phases) -> list[tuple[float, float]]:
    return [(a, b) for n, a, b in t.host if phase(n) in phases]


def idle_ms(ctx, phases) -> float | None:
    """Mean milliseconds a request spends with the device idle inside its
    spans of ``phases``."""
    if not _readable(ctx):
        return None
    idle = idle_in_requests(ctx.trace, _phase_spans(ctx.trace, phases))
    return 1e3 * sum(idle) / len(idle)


def count(ctx, name: str) -> float | None:
    """Mean number of spans of phase ``name`` that start in a request."""
    if not _readable(ctx):
        return None
    t = ctx.trace
    starts = sorted(a for a, _ in _phase_spans(t, (name,)))
    n = sum(bisect.bisect_left(starts, rb) - bisect.bisect_left(starts, ra)
            for ra, rb in t.requests)
    return n / len(t.requests)


def named_share(ctx) -> float | None:
    """Percent of the requests' device-idle time (the numerator of
    ``host_ms``) that falls inside some phase span."""
    if not _readable(ctx):
        return None
    t = ctx.trace
    idle = sum(d - busy for d, busy in metrics_ctx.device_in_requests(t))
    if idle <= 0:
        return None
    named = idle_in_requests(t, _phase_spans(t, PHASES))
    return 100.0 * sum(named) / idle
