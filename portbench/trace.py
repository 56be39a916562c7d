"""torch.profiler over a run's measured window, and what readers take from it.

The harness marks the window and each request with spans of its own
(``record_function``), so they share the trace's clock with the device's
kernels and copies.  ``Trace`` keeps, in seconds on that clock: the
window, the requests, every device interval (kernels, copies, sets), and
the host's operations (ATen ops and CUDA runtime calls).  The trace goes
through a file in ``TMPDIR``, which is deleted once read.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
REQUEST_SPAN = "portbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
NAME_CHARS = 120


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Covered:
    """How much of any span a union of intervals covers, by bisection."""

    def __init__(self, merged):
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.prefix = [0.0]
        for a, b in merged:
            self.prefix.append(self.prefix[-1] + (b - a))

    def within(self, a: float, b: float) -> float:
        if b <= a or not self.starts:
            return 0.0
        i = bisect.bisect_right(self.ends, a)       # first ending after a
        j = bisect.bisect_left(self.starts, b)      # first starting at/after b
        if i >= j:
            return 0.0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0.0, a - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - b)
        return total


@dataclass
class Trace:
    window: tuple = (0.0, 0.0)
    requests: list = field(default_factory=list)
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end), by start

    @classmethod
    def from_events(cls, events) -> "Trace":
        t = cls()
        windows = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            a = float(e["ts"]) * 1e-6
            b = a + float(e.get("dur", 0)) * 1e-6
            if cat in DEVICE_CATS:
                t.device.append((name, a, b))
            elif name == WINDOW_SPAN and cat == "user_annotation":
                windows.append((a, b))
            elif name == REQUEST_SPAN and cat == "user_annotation":
                t.requests.append((a, b))
            elif cat in HOST_CATS:
                t.host.append((name, a, b))
        if windows:
            t.window = windows[0]
        t.requests.sort()
        t.host.sort(key=lambda x: x[1])
        return t

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        """The union of the device's intervals, cut to the window."""
        w0, w1 = self.window
        return merge((max(a, w0), min(b, w1)) for _, a, b in self.device
                     if b > w0 and a < w1)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time in the window, in
        seconds, summed by name."""
        w0, w1 = self.window
        by = collections.Counter()
        for name, a, b in self.device:
            if b > w0 and a < w1:
                by[name[:NAME_CHARS]] += min(b, w1) - max(a, w0)
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time in the window, summed by what the host
        was doing at the middle of each gap: the innermost host operation
        running then, else "after" the last one that had ended, or
        "between requests" outside every request."""
        w0, w1 = self.window
        edges = [w0]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(w1)
        starts = [a for _, a, _ in self.host]
        req_starts = [a for a, _ in self.requests]
        by = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            by[self._doing((a + b) / 2, starts, req_starts)] += b - a
        return [[n, s] for n, s in by.most_common(top)]

    def _doing(self, m: float, starts, req_starts) -> str:
        r = bisect.bisect_right(req_starts, m) - 1
        if r < 0 or self.requests[r][1] < m:
            return "between requests"
        i = bisect.bisect_right(starts, m) - 1
        for k in range(i, max(i - 64, -1), -1):
            name, _a, b = self.host[k]
            if b >= m:
                return name[:NAME_CHARS]
        if i >= 0 and self.host[i][1] >= self.requests[r][0]:
            return "after " + self.host[i][0][:NAME_CHARS]
        return "host code before the first operation"


class Profiler:
    """torch.profiler with the host's and (on a card) the device's
    activity; ``stop()`` returns the ``Trace``."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> Trace:
        self._prof.stop()
        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return Trace.from_events(events)


def span(name: str):
    """A span of the harness's own in the trace."""
    from torch.profiler import record_function
    return record_function(name)
