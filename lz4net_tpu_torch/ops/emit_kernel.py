"""Compressed bytes from sequence records (encode E5).

Port of the TPU kernel ``lz4net_tpu/ops/emit_kernel.py: emit_bytes``.
The CUDA kernel is ``csrc/emit_kernel.cu`` (its header says what bounds
it on the H100 and what the design does about that);
``emit_bytes_reference`` is its plain PyTorch version.

Record k starts at output byte ``s0[k]`` (monotone over the live
records, ``BIGKEY`` for dead ones) and holds its token, the literal-run
length extension (255s, then the remainder), ``lit_len`` literals taken
from input position ``lit_start``, and, where ``mlen > 0``, the 16-bit
offset and the match-length extension.  For every output byte o below
``out_len`` the governing record is the last one with ``s0 <= o``; the
byte is arithmetic in that record's fields.  Literal bytes come back as
their input index in ``cidx`` (-1 elsewhere) with 0 in ``direct``.  The
kernel finds each byte's record by a tile expansion over ``s0``, exact
where ``s0`` never decreases (as both record producers give it), so no
byte goes ungoverned and ``miss`` is always 0.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import MINMATCH, ML_MASK, RUN_MASK

BIGKEY = 1 << 23     # key of a dead record, beyond every output byte

launches = 0


def _check(fields, out_len, O):
    s0 = fields[0]
    for t in (*fields, out_len):
        if t.dtype != torch.int32 or t.device != s0.device:
            raise TypeError("all inputs must be int32 on one device")
    if s0.dim() != 2 or any(t.shape != s0.shape for t in fields):
        raise ValueError("s0/lit_start/lit_len/off/mlen must be [B, S]")
    if out_len.shape != (s0.shape[0],) or O <= 0 or O >= BIGKEY:
        raise ValueError(f"out_len must be [B] and 0 < O < {BIGKEY}")


def emit_bytes(s0, lit_start, lit_len, off, mlen, out_len, O: int):
    """s0/lit_start/lit_len/off/mlen: [B, S] int32; out_len: [B] int32.
    Returns (direct [B, O], cidx [B, O], miss [B]), all int32.

    Precondition: ``s0`` never decreases along a row (``sequence_records``
    and ``parse_records`` give that, dead records last at ``BIGKEY``).  It
    is not checked: on a row where ``s0`` decreases the kernel's bytes may
    differ from ``emit_bytes_reference``'s, but it reads and writes
    nothing outside the buffers."""
    global launches
    fields = (s0, lit_start, lit_len, off, mlen)
    _check(fields, out_len, O)
    if s0.device.type == "cpu":
        return emit_bytes_reference(*fields, out_len, O)
    if s0.device.type != "cuda":
        raise ValueError(f"unsupported device {s0.device}")
    ins = [t.contiguous() for t in (*fields, out_len)]
    B, S = s0.shape
    direct = torch.empty((B, O), dtype=torch.int32, device=s0.device)
    cidx = torch.empty_like(direct)
    _build.launch("lz4t_emit_bytes", s0.device,
                  *(t.data_ptr() for t in ins), direct.data_ptr(),
                  cidx.data_ptr(), B, S, O)
    launches += 1
    return direct, cidx, torch.zeros_like(out_len)


def emit_bytes_reference(s0, lit_start, lit_len, off, mlen, out_len,
                         O: int):
    """Plain PyTorch version of ``emit_bytes`` (same outputs)."""
    B = s0.shape[0]
    o = torch.arange(O, dtype=torch.int32,
                     device=s0.device).expand(B, O).contiguous()
    t = torch.searchsorted(s0.contiguous(), o, right=True) - 1
    tc = t.clamp(min=0)

    def field(v):
        return torch.gather(v, 1, tc)

    s0q, lsq, llq, offq, mlq = map(field, (s0, lit_start, lit_len, off,
                                           mlen))
    found = (t >= 0) & (s0q >= 0) & (s0q <= o) & (s0q < BIGKEY - 1)

    e_lit = (llq - RUN_MASK).clamp(min=0)
    lit_ext = torch.where(llq >= RUN_MASK, 1 + e_lit // 255, 0)
    has_m = mlq > 0
    mm = (mlq - MINMATCH).clamp(min=0)
    e_m = (mm - ML_MASK).clamp(min=0)
    m_ext = torch.where(has_m & (mm >= ML_MASK), 1 + e_m // 255, 0)
    size = 1 + lit_ext + llq + torch.where(has_m, 2 + m_ext, 0)

    r = o - s0q
    live = found & (o < out_len[:, None]) & (r < size)
    tok = (llq.clamp(max=RUN_MASK) << 4) \
        | torch.where(has_m, mm, 0).clamp(max=ML_MASK)
    lit_o = 1 + lit_ext                     # record-relative offsets
    off_o = lit_o + llq
    mext_o = off_o + 2
    # length-extension bytes: 255s, then the remainder
    lext_b = torch.where(r - 1 < lit_ext - 1, 255,
                         e_lit - 255 * (lit_ext - 1).clamp(min=0))
    mext_b = torch.where(r - mext_o < m_ext - 1, 255,
                         e_m - 255 * (m_ext - 1).clamp(min=0))
    direct = torch.where(
        r == 0, tok, torch.where(
            r < lit_o, lext_b, torch.where(
                r < off_o, 0, torch.where(
                    r == off_o, offq & 0xFF, torch.where(
                        r == off_o + 1, offq >> 8, mext_b)))))
    in_lit = live & (r >= lit_o) & (r < off_o)
    cidx = torch.where(in_lit, lsq + (r - lit_o), -1)
    return (torch.where(live, direct & 0xFF, 0).to(torch.int32),
            cidx.to(torch.int32), torch.zeros_like(out_len))
