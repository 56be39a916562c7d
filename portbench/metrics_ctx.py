"""What a metric's reader gets (``Context``), and the arithmetic the
readers share: percentiles, the device's busy time inside spans, and the
least time a request's bytes need at the chip's peak bandwidth."""

from __future__ import annotations

import json
import os
import statistics
from dataclasses import dataclass

from portbench import trace as pbtrace

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


@dataclass
class Context:
    setup_s: float
    window_s: float          # host clock, first request sent to last back
    latencies: list          # seconds, every request of the window
    work: list               # (bytes given, bytes returned, least bytes)
    trace: pbtrace.Trace | None = None   # rank 0's, in a traced run
    busy_s: float | None = None          # averaged over the ranks
    device_kind: str = "cpu"


def percentile(values, q: int) -> float:
    """The ``q``-th percentile of all values (``statistics.quantiles``,
    inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def peak_bytes_per_s(kind: str) -> float | None:
    with open(PEAKS) as fh:
        devices = json.load(fh)["devices"]
    entry = devices.get(kind)
    return entry["hbm_bytes_per_s"] if entry else None


def roofline_share(least_bytes: float, busy_s: float,
                   bytes_per_s: float) -> float:
    """Percent of the device's busy time that the bytes would need at the
    peak bandwidth: each byte read once or written once."""
    return 100.0 * (least_bytes / bytes_per_s) / busy_s


def device_in_requests(t: pbtrace.Trace) -> list[tuple[float, float]]:
    """(request seconds, device busy seconds inside it) for each request
    of the traced window."""
    covered = pbtrace.Covered(t.busy())
    return [(b - a, covered.within(a, b)) for a, b in t.requests]


def traced_device(ctx: Context) -> bool:
    """Whether the run's trace holds device time to read."""
    return ctx.trace is not None and bool(ctx.busy_s)


def host_ms(ctx: Context) -> float | None:
    """Mean milliseconds a request spends with the device idle: its
    host-clock span less the device's busy time inside it."""
    if not traced_device(ctx) or not ctx.trace.requests:
        return None
    spans = device_in_requests(ctx.trace)
    return 1e3 * sum(d - busy for d, busy in spans) / len(spans)


def device_idle(ctx: Context) -> float | None:
    """Percent of the traced window in which no kernel, copy or set ran
    on the device (the busy time averaged over the ranks)."""
    if not traced_device(ctx):
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace.window_s)


def window_roofline(ctx: Context) -> float | None:
    """Percent of the device's busy time in the window that the window's
    requests need at the peak bandwidth: the bytes each must read and
    write once, whatever kernels do the work."""
    peak = peak_bytes_per_s(ctx.device_kind)
    if peak is None or not traced_device(ctx) or not ctx.work:
        return None
    return roofline_share(sum(w[2] for w in ctx.work), ctx.busy_s, peak)
