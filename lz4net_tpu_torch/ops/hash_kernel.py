"""Per-block hash-table match candidates (encode E1, and the HC tiers).

Port of two TPU kernels of ``lz4net_tpu/ops/hash_kernel.py``:
``_bucket_prev_pallas`` (reached through ``bucket_prev_impl``), whose
CUDA kernel is ``csrc/hash_kernel.cu`` and whose plain PyTorch version is
``bucket_prev_reference``; and ``_hc_tables_pallas`` (reached through
``hc_tables`` and ``hc_candidates``, at the end of this module), whose
CUDA kernel is ``csrc/hc_kernel.cu`` and whose plain version is
``hc_tables_reference``.  Each kernel's header says what bounds it on the
H100 and what its design does about that.

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

import ctypes

import torch

from .. import _build

LANE = 128
CHUNK = 4 * LANE
MAX_D = 21 * 8192            # a 96 KB block behind a 64 KB window; the
                             # kernel's tables keep position + 1 in 18
                             # bits
NB = 8192                    # buckets: the reference's 64K-input table
NBROWS = 64                  # NB in 128-bucket rows
HASH_MUL = -1640531535       # 2654435761 as int32
MIX8 = -1262405129           # odd mixer of the 8-byte key
MIX12 = -1028477387          # odd mixers of the wide-prefix keys
MIX16 = -1640531527
MIX32 = -2048144789
RUN_ROWS = 8                 # byte-run tables: 768 keys in 8 rows
MAX_TABLES = 8               # tables of one hc_tables call

launches = 0                 # bucket_prev's kernel
hc_launches = 0              # hc_tables' kernel


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
    if D % CHUNK or D > MAX_D:
        raise ValueError(f"D must be a multiple of {CHUNK}, at most {MAX_D}")


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


# ------------------------------------------------- HC candidate tables
#
# The reference HC search walks a chain of earlier positions with the
# same 4-byte hash and keeps the longest match.  The fast-HC encoder
# stands in for the walk with more count-guarded bucket tables, probed and
# updated chunk by chunk as bucket_prev's: wide-prefix tables (12, 16 and
# 32 bytes hashed), a sticky 8-byte table whose buckets keep their first
# committed entry (the far end of the chain), and three byte-run tables
# keyed by (byte value, minimum-run tier) whose writers and queries are
# run starts.  Candidates are u32-verified; the bytes past 4 are trusted
# to the hash, so callers evaluate lengths with claim = False.


def _wrap32(v):
    """int64 -> int32 with two's-complement wraparound."""
    return (((v + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def hash_fold(words, mix: int):
    """Bucket of a wide prefix: fold the u32 words with an odd mixer,
    ``h = (h * mix) ^ w`` wrapping in int32 at every step, then
    ``hash_bucket``."""
    h = words[0]
    for w in words[1:]:
        h = _wrap32(h.long() * mix) ^ w
    return hash_bucket(h)


def _check_hc(wa, hs, sticky, nrows, D):
    if wa.dtype != torch.int32 or wa.dim() != 2 or wa.shape[1] != D:
        raise ValueError("wa must be [B, D] int32")
    if not hs or len(hs) != len(sticky) or len(hs) != len(nrows):
        raise ValueError("hs, sticky and nrows must have one entry a table")
    for h in hs:
        if h.dtype != torch.int32 or h.device != wa.device \
                or h.shape != wa.shape:
            raise ValueError("every hash stream must be [B, D] int32 on "
                             "wa's device")
    if any(not 0 < r <= NBROWS for r in nrows):
        raise ValueError(f"nrows must be in [1, {NBROWS}]")
    if len(hs) > MAX_TABLES:
        raise ValueError(f"at most {MAX_TABLES} tables")
    if D % CHUNK:
        raise ValueError(f"D must be a multiple of {CHUNK}")


def hc_tables(wa, hs, sticky, nrows, D: int):
    """Probe-then-update bucket tables over a block's 512-position chunks.

    wa: [B, D] int32 u32 words (the verification values); hs: one [B, D]
    int32 stream of bucket ids a table; sticky[t]: the table keeps its
    first committed entry; nrows[t]: its size in 128-bucket rows.
    Returns one [B, D] int32 candidate stream a table: the stored
    position where the bucket, as of the chunk's start, holds one whose
    u32 equals ``wa[i]``, else -1."""
    global hc_launches
    _check_hc(wa, hs, sticky, nrows, D)
    if wa.device.type == "cpu":
        return hc_tables_reference(wa, hs, sticky, nrows, D)
    if wa.device.type != "cuda":
        raise ValueError(f"unsupported device {wa.device}")
    nt = len(hs)
    wa = wa.contiguous()
    hs = [h.contiguous() for h in hs]
    # the streams' device pointers and (buckets, sticky) a table, in host
    # memory: the C entry copies them into the launch's arguments
    ptrs = (ctypes.c_void_p * nt)(*(h.data_ptr() for h in hs))
    meta = (ctypes.c_int * (2 * nt))(*(v for r, s in zip(nrows, sticky)
                                       for v in (r * LANE, int(bool(s)))))
    cands = torch.empty((nt, *wa.shape), dtype=torch.int32,
                        device=wa.device)
    _build.launch("lz4t_hc_tables", wa.device, wa.data_ptr(),
                  ctypes.addressof(ptrs), ctypes.addressof(meta),
                  cands.data_ptr(), wa.shape[0], D, nt)
    hc_launches += 1
    return tuple(cands.unbind(0))


def hc_tables_reference(wa, hs, sticky, nrows, D: int):
    """Plain PyTorch version of ``hc_tables`` (same outputs): the chunk
    walk of ``bucket_prev_reference`` with one table a stream."""
    B = wa.shape[0]
    dev = wa.device
    ones = torch.ones((B, CHUNK), dtype=torch.int32, device=dev)
    lane = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    out = []
    for h, stick, nr in zip(hs, sticky, nrows):
        nb = nr * LANE
        # column nb takes the writes that must not land
        tp = torch.zeros((B, nb + 1), dtype=torch.int32, device=dev)
        tw = torch.zeros_like(tp)
        hk = h.clamp(0, nb - 1).long()
        cand = torch.empty_like(wa)
        for c0 in range(0, D, CHUNK):
            sl = slice(c0, c0 + CHUNK)
            k, w = hk[:, sl], wa[:, sl]
            tc = torch.gather(tp, 1, k)
            ok = (tc > 0) & (torch.gather(tw, 1, k) == w)
            cand[:, sl] = torch.where(ok, tc - 1, -1)
            cnt = torch.zeros_like(tp).scatter_add_(1, k, ones)
            one = torch.gather(cnt, 1, k) == 1
            if stick:
                one &= tc == 0
            dst = torch.where(one, k, nb)
            tp.scatter_(1, dst, (c0 + 1 + lane).expand(B, CHUNK))
            tw.scatter_(1, dst, w)
        out.append(cand)
    return tuple(out)


def shift_left(w, n):
    """y[:, i] = w[:, i + n], zero past the end."""
    return torch.cat([w[:, n:], torch.zeros_like(w[:, :n])], dim=1)


def hc_streams(x, wa, wb, is_rs, run_fwd, tables=None):
    """The ``hc_tables`` operands of a table set: (names, hs, sticky,
    nrows).  ``tables`` is a comma-separated subset of
    "12,16,32,s8,runs" (the default: all of them); "runs" stands for the
    three byte-run tables (minimum runs 4, 16 and 64), named "r4", "r16"
    and "r64"."""
    want = [w.strip() for w in (tables or "12,16,32,s8,runs").split(",")
            if w.strip()]
    def prefix(nwords):            # the u32 words of a prefix
        return (wa, wb) + tuple(shift_left(wa, 4 * k)
                                for k in range(2, nwords))

    spec = {"12": lambda: hash_fold(prefix(3), MIX12),
            "16": lambda: hash_fold(prefix(4), MIX16),
            "32": lambda: hash_fold(prefix(8), MIX32),
            "s8": lambda: hash_bucket8(wa, wb)}
    names = [w for w in want if w in spec]
    hs = [spec[w]() for w in names]
    sticky = [w == "s8" for w in names]
    nrows = [NBROWS] * len(names)
    if "runs" in want:
        dump = RUN_ROWS * LANE - 1     # catch-all bucket of non-runs
        for ti, mr in enumerate((4, 16, 64)):
            names.append(f"r{mr}")
            hs.append(torch.where(is_rs & (run_fwd >= mr), x + 256 * ti,
                                  dump))
            sticky.append(False)
            nrows.append(RUN_ROWS)
    return names, hs, sticky, nrows


def hc_candidates(x, wa, wb, is_rs, run_fwd, D: int, tables=None):
    """HC candidate streams from one ``hc_tables`` pass.

    x: [B, D] int32 bytes; wa/wb: the u32 words at i and i+4; is_rs:
    [B, D] bool run starts; run_fwd: [B, D] int32 forward run lengths;
    ``tables`` as for ``hc_streams``.  Returns (deep, first, runs):
    ``deep`` the widest prefix table that hit (32 over 16 over 12
    bytes), ``first`` the sticky 8-byte table, ``runs`` the three
    byte-run streams; -1 where a table was not asked for."""
    names, hs, sticky, nrows = hc_streams(x, wa, wb, is_rs, run_fwd,
                                          tables)
    by = dict(zip(names, hc_tables(wa, hs, sticky, nrows, D)))
    none = torch.full_like(wa, -1)
    deep = none
    for w in ("12", "16", "32"):
        if w in by:
            deep = torch.where(by[w] >= 0, by[w], deep)
    runs = [by.get(w, none) for w in ("r4", "r16", "r64")]
    return deep, by.get("s8", none), runs
