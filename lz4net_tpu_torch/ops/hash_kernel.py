"""Per-block hash-table match candidates (encode E1).

Port of the TPU kernel ``lz4net_tpu/ops/hash_kernel.py:
_bucket_prev_pallas`` (reached through ``bucket_prev_impl``).  The CUDA
kernel is ``csrc/hash_kernel.cu`` (its header says what bounds it on the
H100 and what the design does about that); ``bucket_prev_reference`` is
its plain PyTorch version.

A block is scanned in 512-position chunks, in order.  For every position
i the candidate ``prev[i]`` is the first hit of:

1. the nearest j in i's near window with 8 bytes equal (``wa`` and
   ``wb``, the u32 words at j and j+4);
2. the 8-byte table's entry for ``h8[i]``, if its stored u32 equals
   ``wa[i]``;
3. the nearest j in the near window with ``wa[j] == wa[i]``;
4. the 4-byte table's entry for ``h4[i]``, if its stored u32 equals
   ``wa[i]``;

else -1.  The near window is i's 128-position row of the chunk and the
row before it in the same chunk (the first row of a chunk looks back
only within itself).  Both 8192-bucket tables hold (position + 1, u32)
as of the chunk start, 0 meaning empty; after the chunk's probes, a
bucket hit by exactly one position of the chunk takes that position's
entry and a bucket hit more than once keeps its old entry.
"""

from __future__ import annotations

import torch

from .. import _build

LANE = 128
CHUNK = 4 * LANE
NB = 8192                    # buckets: the reference's 64K-input table
HASH_MUL = -1640531535       # 2654435761 as int32
MIX8 = -1262405129           # odd mixer of the 8-byte key

launches = 0


def hash_bucket(w):
    """The reference's multiplicative hash onto NB buckets,
    ``(w * 2654435761 mod 2^32) >> 19``.  Computed in int64, so the
    product never overflows; bits 19-31 of it are the bucket."""
    return ((w.long() * HASH_MUL >> 19) & (NB - 1)).to(torch.int32)


def hash_bucket8(wa, wb):
    """Bucket of the 8-byte prefix (wa = u32 at i, wb = u32 at i+4)."""
    key = (wa.long() ^ (wb.long() * MIX8)) & 0xFFFFFFFF
    return ((key * HASH_MUL >> 19) & (NB - 1)).to(torch.int32)


def _check(wa, wb, h4, h8, D):
    for t in (wa, wb, h4, h8):
        if t.dtype != torch.int32 or t.device != wa.device:
            raise TypeError("wa, wb, h4, h8 must be int32 on one device")
        if t.dim() != 2 or t.shape != wa.shape or t.shape[1] != D:
            raise ValueError("wa, wb, h4, h8 must all be [B, D]")
    if D % CHUNK:
        raise ValueError(f"D must be a multiple of {CHUNK}")


def bucket_prev(wa, wb, h4, h8, D: int):
    """wa/wb: [B, D] int32 u32 words at i and i+4; h4/h8: [B, D] int32
    buckets (``hash_bucket``, ``hash_bucket8``); D % 512 == 0.  Returns
    prev [B, D] int32."""
    global launches
    _check(wa, wb, h4, h8, D)
    if wa.device.type == "cpu":
        return bucket_prev_reference(wa, wb, h4, h8, D)
    if wa.device.type != "cuda":
        raise ValueError(f"unsupported device {wa.device}")
    ins = [t.contiguous() for t in (wa, wb, h4, h8)]
    prev = torch.empty_like(ins[0])
    near = torch.empty_like(ins[0])          # the near-window results
    _build.launch("lz4t_bucket_prev", wa.device,
                  *(t.data_ptr() for t in ins), prev.data_ptr(),
                  near.data_ptr(), wa.shape[0], D)
    launches += 1
    return prev


def _near_window(wa, wb, D):
    """(m4, m8): the nearest position of the near window whose u32 (m4),
    or whose u32 and next u32 (m8), equal position i's; -1 if none."""
    i = torch.arange(D, dtype=torch.int32, device=wa.device)
    li = i % CHUNK
    # how far back the window reaches from i
    reach = torch.where(li < LANE, li, LANE + li % LANE)
    m4 = torch.full_like(wa, -1)
    m8 = torch.full_like(wa, -1)
    for d in range(2 * LANE - 1, 0, -1):        # nearest (smallest d) last
        eqa = torch.zeros_like(wa, dtype=torch.bool)
        eqa[:, d:] = (wa[:, d:] == wa[:, :-d]) & (reach[d:] >= d)
        eqb = torch.zeros_like(eqa)
        eqb[:, d:] = wb[:, d:] == wb[:, :-d]
        m4 = torch.where(eqa, i - d, m4)
        m8 = torch.where(eqa & eqb, i - d, m8)
    return m4, m8


def bucket_prev_reference(wa, wb, h4, h8, D: int):
    """Plain PyTorch version of ``bucket_prev`` (same output): the near
    window for all positions at once, then the tables chunk by chunk,
    with integer scatters for the count-guarded update."""
    B = wa.shape[0]
    dev = wa.device
    m4, m8 = _near_window(wa, wb, D)
    # tables [B, NB + 1]: column NB takes the writes that must not land
    t4p, t4w, t8p, t8w = (torch.zeros((B, NB + 1), dtype=torch.int32,
                                      device=dev) for _ in range(4))
    ones = torch.ones((B, CHUNK), dtype=torch.int32, device=dev)
    lane = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    prev = torch.empty_like(wa)
    for c0 in range(0, D, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        w = wa[:, sl]
        k4, k8 = h4[:, sl].long(), h8[:, sl].long()
        t4c = torch.gather(t4p, 1, k4)
        t4ok = (t4c > 0) & (torch.gather(t4w, 1, k4) == w)
        t8c = torch.gather(t8p, 1, k8)
        t8ok = (t8c > 0) & (torch.gather(t8w, 1, k8) == w)
        n4, n8 = m4[:, sl], m8[:, sl]
        prev[:, sl] = torch.where(
            n8 >= 0, n8, torch.where(
                t8ok, t8c - 1, torch.where(
                    n4 >= 0, n4, torch.where(t4ok, t4c - 1, -1))))
        pos1 = (c0 + 1 + lane).expand(B, CHUNK)
        for tp, tw, k in ((t4p, t4w, k4), (t8p, t8w, k8)):
            cnt = torch.zeros_like(tp).scatter_add_(1, k, ones)
            dst = torch.where(torch.gather(cnt, 1, k) == 1, k, NB)
            tp.scatter_(1, dst, pos1)
            tw.scatter_(1, dst, w)
    return prev
