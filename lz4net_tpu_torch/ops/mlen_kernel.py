"""Match lengths from match candidates (encode E2).

Port of the TPU kernel ``lz4net_tpu/ops/mlen_kernel.py:
match_lengths_fused``.  The CUDA kernel is ``csrc/mlen_kernel.cu`` (its
header says what bounds it on the H100 and what the design does about
that); ``match_lengths_reference`` is its plain PyTorch version, a port
of ``encode_vector._match_lengths`` and ``_top_off_exact`` there.

``u32`` stays in the signature of the JAX kernel, where it is the words
of ``x`` (``words(x)``, zero past the row), as every caller passes it;
neither version reads it: the kernel assembles the words from x's bytes
in shared memory, and the plain version computes them from x.

For position i with candidate ``prev[i]`` (``prev[i] < i``, or -1) and
offset ``off = i - prev``, matched where ``prev >= 0`` and
``off <= 65535``:

* offsets 1-4 and the dominant offsets ``dks`` get the exact length of
  the equal run ``x[j] == x[j - off]`` from j = i on;
* other far offsets get ``4 + (equal low bytes of the u32 words at i+4
  and prev+4)`` (4 + 4 where ``m8`` says the first 8 bytes are known
  equal); the first ``rcap`` positions (in position order) whose first 8
  bytes matched extend by up to 4 bytes a round for ``ext_rounds``
  rounds, the others stay at 8;
* then the format's end rules: no match covers the last 5 bytes of the
  block (``end_abs``), none starts less than 12 bytes before its end,
  and a block (``blk_len``) under 13 bytes has none.

Returns (matched, off, mlen) [B, D] int32, off and mlen 0 where not
matched.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import (LASTLITERALS, MAX_DISTANCE, MFLIMIT, MINLENGTH,
                         MINMATCH)
from .hash_kernel import shift_left

TILE = 4096          # the kernel's scan tile; D must be a multiple
MAX_D = 21 * 8192    # a 96 KB block behind a 64 KB window; the kernel
                     # keeps the bytes and at least one class's break
                     # bitmask in shared memory, and each position's
                     # class byte there too where it fits
MAX_TOP = 24         # at most this many dominant offsets (HC tiers: 24)

launches = 0


def _check(x, u32, prev, m8, dks, end_abs, blk_len, D):
    for t in (x, u32, prev, m8, dks, end_abs, blk_len):
        if t.dtype != torch.int32 or t.device != x.device:
            raise TypeError("all inputs must be int32 on one device")
    B = x.shape[0]
    if D % TILE or D > MAX_D or any(t.shape != (B, D)
                                    for t in (x, u32, prev, m8)):
        raise ValueError(f"x/u32/prev/m8 must be [B, D], D % {TILE} == 0, "
                         f"D <= {MAX_D}")
    if dks.dim() != 2 or dks.shape[0] != B or dks.shape[1] > MAX_TOP:
        raise ValueError(f"dks must be [B, K] with K <= {MAX_TOP}")
    if end_abs.shape != (B,) or blk_len.shape != (B,):
        raise ValueError("end_abs and blk_len must be [B]")


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def match_lengths_fused(x, u32, prev, m8, dks, end_abs, blk_len, D: int,
                        rcap: int, ext_rounds: int = 10):
    """x/u32/prev/m8: [B, D] int32; dks: [B, K] int32 (0 = unused);
    end_abs/blk_len: [B] int32.  Returns (matched, off, mlen)."""
    global launches
    _check(x, u32, prev, m8, dks, end_abs, blk_len, D)
    if x.device.type == "cpu":
        return match_lengths_reference(x, u32, prev, m8, dks, end_abs,
                                       blk_len, D, rcap, ext_rounds)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    # 16-byte aligned rows: the kernel reads x, prev and m8 as int4
    x, prev, m8, dks, end_abs, blk_len = (
        _aligned(t.contiguous()) for t in (x, prev, m8, dks, end_abs,
                                           blk_len))
    matched, off, mlen = (torch.empty_like(x) for _ in range(3))
    # a class byte a position, for rows too wide to keep them in shared
    # memory (the launcher decides; the caching allocator makes it cheap)
    cls = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    _build.launch("lz4t_match_lengths", x.device, x.data_ptr(),
                  u32.data_ptr(), prev.data_ptr(), m8.data_ptr(),
                  dks.data_ptr(), end_abs.data_ptr(), blk_len.data_ptr(),
                  matched.data_ptr(), off.data_ptr(), mlen.data_ptr(),
                  cls.data_ptr(), x.shape[0], D, dks.shape[1], rcap,
                  ext_rounds)
    launches += 1
    return matched, off, mlen


def words(x):
    """words[i] = little-endian 4-byte word of x's bytes at i (zero past
    the row), as int32 (computed in int64, so the top byte's shift cannot
    overflow)."""
    x = x.long()
    w = x | (shift_left(x, 1) << 8) | (shift_left(x, 2) << 16) \
        | (shift_left(x, 3) << 24)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def xor_match_bytes(wa, wb):
    """Number of equal low-order bytes of two u32 words (0..4)."""
    diff = wa ^ wb
    return torch.where(
        (diff & 0xFF) != 0, 0,
        torch.where((diff & 0xFF00) != 0, 1,
                    torch.where((diff & 0xFF0000) != 0, 2,
                                torch.where(diff != 0, 3, 4)))
    ).to(torch.int32)


def run_lengths(eq):
    """run[b, i] = length of the run of True in eq[b] starting at i."""
    D = eq.shape[1]
    i = torch.arange(D, dtype=torch.int32, device=eq.device)
    stop = torch.where(eq, D, i)
    nxt = torch.flip(torch.cummin(torch.flip(stop, [1]), dim=1).values,
                     [1])
    return nxt - i


def _run_at_offset(x, i, d):
    """Equal-run lengths of x against x shifted by d ([B, 1], >= 0)."""
    src = torch.gather(x, 1, (i - d).clamp(min=0).long())
    return run_lengths((x == src) & (i >= d))


def match_lengths_reference(x, u32, prev, m8, dks, end_abs, blk_len,
                            D: int, rcap: int, ext_rounds: int = 10):
    """Plain PyTorch version of ``match_lengths_fused`` (same outputs)."""
    u32 = words(x)      # as the kernel takes them; the argument is unread
    B = x.shape[0]
    i = torch.arange(D, dtype=torch.int32, device=x.device).expand(B, D)
    off = i - prev
    matched = (prev >= 0) & (off <= MAX_DISTANCE)
    far = matched & (off > 4)

    mlen = torch.zeros_like(x)
    for d in range(1, 5):
        run = _run_at_offset(x, i, torch.full((B, 1), d, dtype=torch.int32,
                                              device=x.device))
        mlen = torch.where(matched & (off == d), run, mlen)

    # far offsets: the u32 at i+4 against the u32 at prev+4
    w_i4 = torch.cat([u32[:, 4:], torch.zeros_like(u32[:, :4])], dim=1)
    w_p4 = torch.gather(u32, 1, (prev + 4).clamp(0, D - 1).long())
    nb1 = torch.where(m8 != 0, 4, xor_match_bytes(w_i4, w_p4))
    l_far = torch.where(far, MINMATCH + nb1, 0)
    alive = far & (nb1 == 4)
    # the first rcap survivors extend; the rest stay at MINMATCH + 4
    ext = alive & (torch.cumsum(alive, 1) <= rcap)
    pc = prev.clamp(min=0)
    length = torch.full_like(x, MINMATCH + 4)
    live = ext
    for _ in range(ext_rounds):
        wa = torch.gather(u32, 1, (i + length).clamp(0, D - 1).long())
        wb = torch.gather(u32, 1, (pc + length).clamp(0, D - 1).long())
        nb = torch.where(live, xor_match_bytes(wa, wb), 0)
        length = length + nb
        live = live & (nb == 4)
    l_far = torch.where(ext, length, l_far)
    mlen = torch.where(far, l_far, mlen)

    for t in range(dks.shape[1]):
        dk = dks[:, t:t + 1]
        run = _run_at_offset(x, i, dk)
        mlen = torch.where(far & (off == dk), run, mlen)

    limit = end_abs[:, None] - LASTLITERALS - i
    mlen = torch.minimum(mlen, limit.clamp(min=0))
    matched = matched & (mlen >= MINMATCH) \
        & (i <= end_abs[:, None] - MFLIMIT) \
        & (blk_len[:, None] >= MINLENGTH)
    return (matched.to(torch.int32), torch.where(matched, off, 0),
            torch.where(matched, mlen, 0))
