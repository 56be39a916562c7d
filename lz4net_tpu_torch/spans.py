"""Named phase spans on torch.profiler's clock.

``span(name)`` is a context manager.  While a torch.profiler is
recording it is ``torch.profiler.record_function(name)``: the span lands
in the trace as a ``user_annotation`` event, on the clock that the
device's kernel and copy events share, and its parent is the span that
encloses it on the same thread.  Otherwise it is one shared no-op
context, so the cost with tracing off is one read of the profiler's
enabled flag a call.  README.md lists the port's span names: a root a
call, phase spans inside it, and one span inside a phase,
``lz4t.encode.window`` (``ops/encode_vector.py``), around each laying
of P-mode window rows within ``lz4t.encode.layout``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
