"""The host side of every device pass: rows, kept buffers, upload, fetch.

Every engine of the port runs a device pass the same way on the host.
It lays its batch's byte strings into uint8 rows (``lay``, one a row;
``broadcast``, one shared window into every row), ships them over the
bus as bytes and widens them to int32 on the device where its kernels
take words (``upload``), and brings the results back as bytes
(``fetch``).  The caller makes the rows: the public layout routines
(``decode_vector.pack_blocks`` and ``pack_windows``,
``encode_vector.window_rows`` and ``segment_rows``,
``parallel.pipeline.pack_blocks``) in fresh memory, since their callers
hold the arrays they return, and the engines, whose rows die inside
their call, in a buffer their thread keeps (``HostRows``).  The rows
may come uninitialised: ``lay`` and ``broadcast`` write every byte of
the columns they cover, padding included.

``kept`` holds the one engine of a kind that serves a device, and
``resolve_device`` the one rule for a ``device`` argument.

Uploads are synchronous, from pageable memory: a kept buffer may be laid
again as soon as ``upload`` returns.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_ENGINES: dict = {}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def kept(cls, device):
    """The one ``cls`` engine serving ``device``, made on first use, so
    that its counters and kept buffers last across calls."""
    device = resolve_device(device)     # raises for CUDA without a card
    if (cls, device) not in _ENGINES:
        _ENGINES[cls, device] = cls(device)
    return _ENGINES[cls, device]


class HostRows(threading.local):
    """Uninitialised host rows for a batch, from one buffer a thread
    keeps across batches: fresh memory costs a page fault at first touch
    of every 4 KB (tens of ms, and most of the spread between runs, for
    1,024 rows behind a 64 KB window).  A batch over ``KEEP`` bytes gets
    fresh memory that is not kept, so a thread holds at most ``KEEP``
    bytes a buffer (the dictionary cell's 1,024 rows of 72 KB are 75.5
    MB).  The rows live until the thread's next batch; the upload copies
    them first."""

    KEEP = 96 << 20
    buf = None

    def empty(self, shape, dtype=np.uint8):
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n > self.KEEP:
            return np.empty(shape, dtype)
        if self.buf is None or self.buf.size < n:
            self.buf = np.empty(n, np.uint8)
        return self.buf[:n].view(dtype).reshape(shape)


def lay(rows, bufs, at: int = 0, end=None):
    """Each of ``bufs`` into its row of ``rows`` (uint8): from column
    ``at``, zeros after it to the row's end; or, given ``end``, ending at
    column ``end``, zeros before it from column 0.  Writes only those
    columns.  Returns ``rows``."""
    for row, b in zip(rows, bufs, strict=True):
        lo = at if end is None else end - len(b)
        row[lo:lo + len(b)] = np.frombuffer(b, np.uint8)
        if end is None:
            row[lo + len(b):] = 0
        else:
            row[:lo] = 0
    return rows


def broadcast(rows, buf, end: int):
    """One ``buf`` into every row of ``rows`` by a single broadcast,
    ending at column ``end``, zeros before it from column 0.  Writes only
    those columns.  Returns ``rows``."""
    lo = end - len(buf)
    rows[:, :lo] = 0
    rows[:, lo:end] = np.frombuffer(buf, np.uint8)
    return rows


def upload(device, rows, *lens, widen: bool = False):
    """A pass's inputs on ``device``: ``rows`` (uint8) over the bus as
    bytes, widened to int32 there where ``widen``, then each of ``lens``
    as an int32 vector; None stays None.  On the CPU the rows are copied,
    so that no tensor aliases a kept buffer."""
    device = resolve_device(device)
    if rows is not None:
        rows = torch.from_numpy(rows).to(device)
        rows = (rows.to(torch.int32) if widen
                else rows.clone() if device.type == "cpu" else rows)
    return (rows, *(None if v is None else
                    torch.from_numpy(np.asarray(v, np.int32)).to(device)
                    for v in lens))


def fetch(out, *small):
    """A pass's results as numpy arrays, (out, *small): ``out`` as bytes,
    not words, then ``small``.  The vector engines fetch ``out`` whole:
    cut to the longest payload, it made the unpack of their fast-HC
    payloads 1.5-2 ms slower a batch on an H100's host (256 x 64 KB and
    1,024 x 4 KB blocks), and the copies no faster."""
    return (out.to(torch.uint8).cpu().numpy(),
            *(t.cpu().numpy() for t in small))
