"""Batched fast and fast-HC encode of independent LZ4 blocks on the card.

Port of ``lz4net_tpu/ops/encode_vector.py``: ``encode_batch_vectorized``
(``fused=True``) for ``hc_level`` 0 (fast greedy, :499-548 and :759-783
there) and 1-9 (fast-HC, the HC branch :507-742), with or without a
preset dictionary (P mode, :477-485, :744-749), and
``VectorEncoder.encode_batch`` (:1052-1118), with blocks over 96 KB cut
into 64 KB segments (``_encode_big``, :1120-1212).  Five kernels
carry it, each with its plain PyTorch version beside it, and a sixth
serves the literal bytes:

1. ``hash_kernel.bucket_prev``: each position's match candidate (fast
   mode, and the suffix and hash tiers of HC);
2. ``hash_kernel.hc_tables``: the HC candidate streams of the byte-run
   tables (suffix tiers) or of all seven tables (hash tiers);
3. ``mlen_kernel.match_lengths_fused``: match lengths and the format's
   end rules, once for the base candidates and once a candidate tier;
4. ``seq_kernel.sequence_records``: greedy parse, catch-up, merge and
   the per-record output starts;
5. ``emit_kernel.emit_bytes``: every compressed byte, or the input index
   of a literal;
6. ``fused_gather.rowbase_gather`` (the decode path's gather): the
   literal bytes.

HC's tier policy follows the level: levels 8-9 run the exact sort tiers
(stable multi-key sorts, one ``match_lengths`` dispatch a tier), levels
1-7 the suffix-adjacency tiers (one multi-key sort for every prefix width
at once, plus the run tables); ``hc_tiers`` overrides it ("suffix",
"hash" or "sort").  The sorts order int32 keys as signed values, as
``jax.lax.sort`` does, since the neighbour candidates depend on the order.

The JAX package sends some HC batches to its XLA ``_match_lengths``
instead of the TPU kernel (large D with a large rcap), because of the
TPU's VMEM; the two are bit-identical.  The CUDA ``match_lengths`` has
no such limit up to D = 172,032, so the port always calls its kernel.

``encode_batch_chain`` is the same encoder with the JAX encoder's chain
record path (its ``fused`` branch without the sequence megakernel,
:785-906 there) in place of ``sequence_records``: ``chain_records``
threads the parse chain with ``chain_kernel.mark_chain`` and gathers
every token and record field through ``fused_gather.table_gather``.  It
gives the same bytes; no entry point selects it, and callers that want
it call it directly.

In P mode a row holds the dictionary's last 64 KB right-aligned in its
first P positions (a multiple of 8192) and the block from P on:
candidates reach into the window, tokens start at P or later, no match
reaches below the window's start (P - pre_len), and the format's end
rules count from the block's end ``P + data_len``.  A row is P + the
block wide: the kernels take rows of up to 172,032 positions
(``seq_kernel.MAX_D`` = ``mlen_kernel.MAX_D`` = ``hash_kernel.MAX_D``),
a 96 KB block behind a full 64 KB window.

A block over 96 KB is cut into 64 KB segments, each a P-mode row behind
the 64 KB of input before it (P = 65,536, D = 139,264); the segments of
every big block of a batch encode in one device pass, and each block's
segment payloads join into one block, the literal tail of each segment
merged into the next one's first literal run through the ``aux`` pair
that ``encode_batch_vectorized`` returns.  The chain record path
(``encode_batch_chain``) still takes rows of at most 106,496 positions
(``chain_kernel.MAX_D``; ROADMAP.md queue A, item 7c).

The output is the JAX vector encoder's byte string exactly: format-valid
LZ4 that any decoder reads, not the reference compressor's parse.  A
block the device flags goes to the host compressor, the native host
engine (``models.native.compress_block``, or ``compress_block_hc`` for
HC, and their ``_dict`` forms with a dictionary);
``VectorEncoder.host_encodes`` counts those blocks, and
``VectorEncoder.window_bytes`` the window positions its passes lay into
rows (B x P a pass; a ``lz4t.encode.window`` span around each laying).
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..constants import (LASTLITERALS, MAX_DISTANCE, MAX_DISTANCE_WINDOW,
                         MFLIMIT, MINLENGTH, MINMATCH,
                         maximum_output_length)
from ..models import native
from ..spans import span
from .decode_vector import CH, _cdiv, lay_windows, prefix_windows
from .bigblock import _synth_literals
from .chain_kernel import mark_chain
from .emit_kernel import emit_bytes
from .fused_gather import rowbase_gather, table_gather
from .hash_kernel import (bucket_prev, hash_bucket, hash_bucket8,
                          hc_candidates)
from .hash_kernel import shift_left as _shift_left
from .host_rows import HostRows, fetch, lay, resolve_device, upload
from .mlen_kernel import match_lengths_fused, run_lengths
from .mlen_kernel import words as _u32
from .seq_kernel import parse_records, sequence_records

LANE = 128
TOP_OFFSETS = 8      # dominant offsets given exact unbounded lengths
SUB_STEP = 16        # the offset stream is sampled every SUB_STEP bytes
HC_TOP_OFFSETS = 24  # the same for each HC candidate tier
HC_SUB_STEP = 8
CU_ROUNDS = 2        # catch-up rounds of the fast mode
HC_CU_ROUNDS = 8     # and of HC
RCAP = 4096          # far matches extended past 8 bytes, per block (fast)
HC_TIERS = ("suffix", "hash", "sort")


def _top_offsets_select(off, far, top_offsets=TOP_OFFSETS,
                        sub_step=SUB_STEP):
    """The ``top_offsets`` most frequent far offsets of the offset stream
    sampled every ``sub_step`` bytes, ties to the smaller offset
    (``jax.lax.top_k`` keeps the lower index first; a stable descending
    sort does the same).  Returns dks [B, top_offsets] int32 (0 marks an
    unused slot)."""
    sv = torch.sort(torch.where(far[:, ::sub_step], off[:, ::sub_step], 0),
                    dim=1).values
    K = sv.shape[1]
    kk = torch.arange(K, dtype=torch.int32, device=off.device)
    is_start = torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool),
                          sv[:, 1:] != sv[:, :-1]], dim=1)
    start_next = torch.where(
        torch.cat([is_start[:, 1:],
                   torch.ones_like(is_start[:, :1])], dim=1), kk + 1, K)
    nxt = torch.flip(torch.cummin(torch.flip(start_next, [1]), dim=1)
                     .values, [1])
    cnt = torch.where(is_start & (sv > 0), nxt - kk, -1)
    ti = torch.sort(cnt, dim=1, descending=True, stable=True) \
        .indices[:, :top_offsets]
    dks = torch.gather(sv, 1, ti) * (torch.gather(cnt, 1, ti) > 0)
    return dks.to(torch.int32)


def _match_lengths_dispatch(x, u32, prev, m8, end_abs, blk_len, D, rcap,
                            top_offsets=TOP_OFFSETS, sub_step=SUB_STEP):
    """(matched bool, off, mlen) of candidates ``prev``: the dominant
    offsets of ``prev``'s offset stream, then ``match_lengths_fused``
    (``m8``: the first 8 bytes are known equal)."""
    i = torch.arange(D, dtype=torch.int32, device=x.device)
    off = i - prev
    far = (prev >= 0) & (off <= MAX_DISTANCE) & (off > 4)
    dks = _top_offsets_select(off, far, top_offsets, sub_step)
    matched, off_all, mlen_all = match_lengths_fused(
        x, u32, prev, m8.to(torch.int32), dks, end_abs, blk_len, D, rcap)
    return matched.bool(), off_all, mlen_all


# ---- stable multi-key sorts (the exact and suffix candidate tiers) ------

def _sort_order(keys):
    """order [B, D]: the positions sorted by the int32 ``keys`` tuple,
    lexicographically and as signed values (``jax.lax.sort`` with
    ``num_keys=len(keys)``), equal tuples in position order.  Two keys
    pack into one int64 ``(k0 << 32) + (k1 + 2**31)`` (an odd last key
    stays int32); stable sorts by the packed keys run least significant
    first."""
    packed = []
    for j in range(0, len(keys), 2):
        k = keys[j]
        if j + 1 < len(keys):
            k = (k.long() << 32) + (keys[j + 1].long() + 2**31)
        packed.append(k)
    B, D = keys[0].shape
    order = torch.arange(D, device=keys[0].device).expand(B, D)
    for k in reversed(packed):
        idx = torch.sort(torch.gather(k, 1, order), dim=1,
                         stable=True).indices
        order = torch.gather(order, 1, idx)
    return order


def _same_as_left(keys, order):
    """[B, D] bool: the sorted entry's key tuple equals its left
    neighbour's (False at the first entry)."""
    same = torch.ones_like(order[:, 1:], dtype=torch.bool)
    for k in keys:
        ks = torch.gather(k, 1, order)
        same &= ks[:, 1:] == ks[:, :-1]
    return torch.cat([torch.zeros_like(same[:, :1]), same], dim=1)


def _unsort(order, v):
    """``v`` (in sorted order) back in position order."""
    return torch.empty_like(v).scatter_(1, order, v)


def _prev_occurrence(keys):
    """prev[i] = largest j < i whose ``keys`` tuple equals position i's,
    else -1."""
    order = _sort_order(keys)
    same = _same_as_left(keys, order)
    left = torch.cat([torch.full_like(order[:, :1], -1), order[:, :-1]],
                     dim=1)
    return _unsort(order, torch.where(same, left, -1).to(torch.int32))


def _first_occurrence(keys):
    """first[i] = smallest j < i whose ``keys`` tuple equals position i's,
    else -1."""
    order = _sort_order(keys)
    same = _same_as_left(keys, order)
    k = torch.arange(order.shape[1], device=order.device)
    head = torch.cummax(torch.where(same, 0, k), dim=1).values
    return _unsort(order, torch.where(same, torch.gather(order, 1, head),
                                      -1).to(torch.int32))


def _minpos_scan(pos, edge, inf):
    """Inclusive scan of (mp, ml, tm) = (pos, inf, edge) under the
    combine of ``encode_vector._suffix_candidates`` there: mp the least
    position so far, ml the LCP from that entry to the prefix's right
    edge, tm the least edge.  Positions are distinct, so the combine is
    associative and a log-step (Hillis-Steele) scan is exact."""
    mp, ml, tm = pos, torch.full_like(pos, inf), edge
    s = 1
    while s < pos.shape[1]:
        mpa, mla, tma = mp[:, :-s], ml[:, :-s], tm[:, :-s]
        mpb, mlb, tmb = mp[:, s:], ml[:, s:], tm[:, s:]
        take_a = mpa <= mpb
        mp = torch.cat([mp[:, :s], torch.minimum(mpa, mpb)], dim=1)
        ml = torch.cat([ml[:, :s], torch.where(
            take_a, torch.minimum(mla, tmb), mlb)], dim=1)
        tm = torch.cat([tm[:, :s], torch.minimum(tma, tmb)], dim=1)
        s *= 2
    return mp, ml


def _suffix_candidates(keys):
    """Best earlier-position candidate per position from the order of
    one stable multi-key sort (the suffix-array LCP argument): the sort
    predecessor (A) and successor (B), and the least-position entries
    before (C) and after (D) it with their LCPs; the best by LCP in
    words, ties to the nearest.  Returns (cand [B, D] position or -1,
    lcp4 [B, D] in 0..len(keys))."""
    K = len(keys)
    inf = K + 1
    order = _sort_order(keys)
    pos_s = order.to(torch.int32)
    B = pos_s.shape[0]
    still = torch.ones_like(pos_s[:, 1:], dtype=torch.bool)
    acc = torch.zeros_like(pos_s[:, 1:])
    for k in keys:
        ks = torch.gather(k, 1, order)
        still &= ks[:, 1:] == ks[:, :-1]
        acc += still
    zero = torch.zeros((B, 1), dtype=torch.int32, device=pos_s.device)
    far_pos = torch.full_like(zero, 1 << 30)
    none = torch.full_like(zero, -1)
    edge = torch.cat([zero, acc], dim=1)
    edge_n = torch.cat([edge[:, 1:], zero], dim=1)

    mp, ml = _minpos_scan(pos_s, edge, inf)
    # exclusive: the prefix [0..k-1], extended over edge k
    mpx = torch.cat([far_pos, mp[:, :-1]], dim=1)
    mlx = torch.minimum(torch.cat([zero, ml[:, :-1]], dim=1), edge)
    # the same over the sort-order successors
    mpr, mlr = _minpos_scan(pos_s.flip(1), edge_n.flip(1), inf)
    mpr, mlr = mpr.flip(1), mlr.flip(1)
    mpy = torch.cat([mpr[:, 1:], far_pos], dim=1)
    mly = torch.minimum(torch.cat([mlr[:, 1:], zero], dim=1), edge_n)

    cands = ((torch.cat([none, pos_s[:, :-1]], dim=1), edge),        # A
             (torch.cat([pos_s[:, 1:], none], dim=1), edge_n),       # B
             (mpx, mlx),                                             # C
             (mpy, mly))                                             # D
    best_p = torch.full_like(pos_s, -1)
    best_l = torch.zeros_like(pos_s)
    for cp, cl in cands:
        ok = (cp >= 0) & (cp < pos_s) & (cl >= 1)
        better = ok & ((cl > best_l) | ((cl == best_l) & (cp > best_p)))
        best_p = torch.where(better, cp, best_p)
        best_l = torch.where(better, cl, best_l)
    return _unsort(order, best_p), _unsort(order, best_l)


def _chain_hop(p):
    """p[p[i]] where p[i] >= 0, else -1: the next candidate on the chain.
    The gather clamps -1 to index 0, so the mask keeps a missing
    candidate from turning into position 0."""
    p2 = torch.gather(p, 1, p.clamp(min=0).long())
    return torch.where((p >= 0) & (p2 >= 0), p2, -1)


def _byte_runs(x):
    """(run_fwd, is_rs): the length of the run of equal bytes from each
    position on, and the starts of runs of at least MINMATCH bytes (a
    run's first byte matches only an earlier run's start)."""
    eq_next = torch.cat([x[:, :-1] == x[:, 1:],
                         torch.zeros_like(x[:, :1], dtype=torch.bool)], 1)
    run_fwd = 1 + run_lengths(eq_next)
    prev_byte = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], 1)
    return run_fwd, (run_fwd >= MINMATCH) & (x != prev_byte)


def _hc_tiers(x, u32, u32s4, prev, m8, prev4, prev8, state, end_abs,
              data_len, D, rcap, hc_level, hc_mode):
    """The HC branch of ``_encode_batch_traced`` there (:550-736): more
    candidate tiers, each dispatched to ``match_lengths`` and taken where
    it gives a longer match, analytic byte-run matches, and the lazy
    parse from level 4.  The end rules count from ``end_abs`` (P +
    data_len), the shortest-block rule from ``data_len``.  Returns
    (matched, off, mlen)."""
    matched, off_all, mlen_all = state
    i = torch.arange(D, dtype=torch.int32, device=x.device)
    end = end_abs[:, None]
    run_fwd, is_rs = _byte_runs(x)

    def in_w(c):
        return (c >= 0) & (i - c <= MAX_DISTANCE)

    def inject_run(cand, ml_bound):
        """An analytic run match (candidate, length lower bound), within
        the format's end rules, where it is longer."""
        nonlocal matched, off_all, mlen_all
        ml = torch.minimum(ml_bound, (end - LASTLITERALS - i).clamp(min=0))
        ok = is_rs & in_w(cand) & (ml >= MINMATCH) \
            & (i <= end - MFLIMIT) & (data_len[:, None] >= MINLENGTH)
        better = ok & (ml > mlen_all)
        matched = matched | better
        off_all = torch.where(better, i - cand, off_all)
        mlen_all = torch.where(better, ml, mlen_all)

    def run_bound(cand):
        return torch.minimum(run_fwd, torch.gather(
            run_fwd, 1, cand.clamp(min=0).long()))

    def sh(k):
        return _shift_left(u32, k)

    def wide():                    # the 32-byte prefix in u32 words
        return (u32, u32s4) + tuple(sh(4 * k) for k in range(2, 8))

    cand_sets = []                 # (candidates, first 8 bytes verified)
    if hc_mode != "sort":
        if hc_mode == "suffix":
            deep, _ = _suffix_candidates(wide())
            merged = torch.where(in_w(deep), deep, -1)
            _, _, run_cands = hc_candidates(x, u32, u32s4, is_rs, run_fwd,
                                            D, tables="runs")
        else:
            deep, first_c, run_cands = hc_candidates(x, u32, u32s4, is_rs,
                                                     run_fwd, D)
            prev2 = _chain_hop(prev)
            merged = torch.where(
                in_w(deep), deep, torch.where(
                    in_w(first_c), first_c,
                    torch.where(in_w(prev2), prev2, -1)))
        cand_sets.append((merged, False))
        # the widest minimum-run tier that hit
        r4c, r16c, r64c = run_cands
        rc = torch.where(in_w(r64c), r64c, torch.where(in_w(r16c), r16c,
                                                       r4c))
        inject_run(rc, run_bound(rc))
    else:
        cand_sets += [
            (_chain_hop(prev8), True),                 # 2nd-nearest 8B
            (_first_occurrence((u32, u32s4)), True),
            (_chain_hop(prev4), False),                # 2nd-nearest 4B
            (_prev_occurrence((u32, u32s4, sh(8))), True),
            (_prev_occurrence((u32, u32s4, sh(8), sh(12))), True)]
        ws = wide()
        if hc_level >= 2:
            cand_sets.append((_prev_occurrence(ws), True))     # 32B
        cand_sets.append((_suffix_candidates(ws)[0], False))
        for min_run in (MINMATCH, 16, 64):
            keyr = torch.where(is_rs & (run_fwd >= min_run), x, 300)
            prev_rs = _prev_occurrence((keyr,))
            inject_run(prev_rs, run_bound(prev_rs))

    for prev_t, verified8 in cand_sets:
        ok_t = in_w(prev_t)
        # the "first 8 bytes verified" claim follows the candidate used
        claim = (ok_t & verified8) | (~ok_t & m8)
        m_t, off_t, ml_t = _match_lengths_dispatch(
            x, u32, torch.where(ok_t, prev_t, prev), claim, end_abs,
            data_len, D, rcap, HC_TOP_OFFSETS, HC_SUB_STEP)
        better = m_t & ok_t & (ml_t > mlen_all)
        matched = matched | better
        off_all = torch.where(better, off_t, off_all)
        mlen_all = torch.where(better, ml_t, mlen_all)

    if hc_level >= 4:
        # lazy parse: defer a match when i+1 holds a longer one, or i+2
        # one longer by more than 1; a defer holds only if its
        # beneficiary is not deferred itself (exactly 4 rounds)
        ml1, ml2 = _shift_left(mlen_all, 1), _shift_left(mlen_all, 2)
        m1, m2 = _shift_left(matched, 1), _shift_left(matched, 2)
        r1 = m1 & (ml1 > mlen_all)
        r2 = m2 & (ml2 > mlen_all + 1)
        defer = r1 | r2
        for _ in range(4):
            defer = (r1 & ~_shift_left(defer, 1)) \
                | (r2 & ~_shift_left(defer, 2))
        matched = matched & ~defer
    return matched, off_all, mlen_all


def _match_stage(x, data_len, D: int, rcap: int, hc_level: int,
                 hc_tiers: str | None, P: int = 0, pre_len=None):
    """E1-E2: per-position (matched, off, mlen) and the u32 words, in P
    mode masked to tokens at or after P whose match stays in the window
    (:744-749 there).  Returns (u32, matched [B, D] int32 0/1, off_all,
    mlen_all)."""
    if hc_tiers not in (None,) + HC_TIERS:
        raise ValueError(f"hc_tiers must be one of {HC_TIERS} or None")
    hc_mode = hc_tiers or ("sort" if hc_level >= 8 else "suffix")
    exact = hc_level > 0 and hc_mode == "sort"
    u32 = _u32(x)
    u32s4 = _shift_left(u32, 4)
    i = torch.arange(D, dtype=torch.int32, device=x.device)
    prev4 = prev8 = None
    if not exact:
        prev = bucket_prev(u32, u32s4, hash_bucket(u32),
                           hash_bucket8(u32, u32s4), D)
        m8 = torch.zeros_like(prev, dtype=torch.bool)
    else:
        prev4 = _prev_occurrence((u32,))
        prev8 = _prev_occurrence((u32, u32s4))
        m8 = (prev8 >= 0) & (i - prev8 <= MAX_DISTANCE)
        prev = torch.where(m8, prev8, prev4)
    end_abs = P + data_len
    state = _match_lengths_dispatch(x, u32, prev, m8, end_abs, data_len,
                                    D, rcap)
    if hc_level > 0:
        state = _hc_tiers(x, u32, u32s4, prev, m8, prev4, prev8, state,
                          end_abs, data_len, D, rcap, hc_level, hc_mode)
    matched, off_all, mlen_all = state
    if P:
        matched = matched & (i >= P) \
            & (off_all <= i - (P - pre_len[:, None]))
    return u32, matched.to(torch.int32), off_all, mlen_all


def _emit_stage(x, records, O: int, S_cap: int):
    """E5: the compressed bytes from the sequence records (the outputs of
    ``sequence_records`` or ``chain_records``).  Returns (out [B, O],
    out_len [B], ok [B])."""
    s0k, lit_src, lit_len, off_k, mlen_k, stats = records
    n_seqs, n_m, out_len = stats[:, 0], stats[:, 1], stats[:, 2]
    direct, cidx, miss = emit_bytes(s0k, lit_src, lit_len, off_k, mlen_k,
                                    out_len, O)
    is_lit = cidx >= 0
    lvals, _ = rowbase_gather(x, torch.where(is_lit, cidx, 0))
    o = torch.arange(O, dtype=torch.int32, device=x.device)
    out = (torch.where(is_lit, lvals, direct) & 0xFF) \
        * (o[None, :] < out_len[:, None])
    ok = (n_seqs < S_cap) & (n_m < S_cap) & (miss == 0)
    return out, out_len, ok


def _encode(records, x, data_len, D, O, S_cap, rcap, hc_level, hc_tiers,
            P, pre_len):
    """E1-E2, then ``records`` (``sequence_records`` or ``chain_records``)
    for E3-E4, then E5."""
    if pre_len is None:
        pre_len = torch.full_like(data_len, P)
    u32, matched, off_all, mlen_all = _match_stage(
        x, data_len, D, rcap, hc_level, hc_tiers, P, pre_len)
    recs = records(
        u32, matched, off_all, mlen_all, P + data_len, pre_len, D, S_cap,
        P=P, cu_rounds=HC_CU_ROUNDS if hc_level else CU_ROUNDS)
    # aux: the first record's and the tail's literal lengths (stats
    # columns 3-4: the tail's where there is no match record)
    return (*_emit_stage(x, recs, O, S_cap), recs[5][:, 3:5])


def encode_batch_vectorized(x, data_len, D: int, O: int, S_cap: int,
                            rcap: int = RCAP, hc_level: int = 0,
                            hc_tiers: str | None = None, P: int = 0,
                            pre_len=None):
    """Greedy-encode a batch of independent blocks.

    x: [B, D] int32 bytes (zero padded), data_len: [B] int32,
    D % 8192 == 0, O >= maximum_output_length(D - P) the padded output
    width, S_cap the record cap (D // 4 + a margin never overflows).
    ``hc_level`` 1-9 runs fast-HC; ``hc_tiers`` ("suffix", "hash",
    "sort") overrides its level's tier policy.  ``P`` > 0 (a multiple
    of 8192) is preset-dictionary mode: x[:, :P] holds the window
    right-aligned, the block starts at column P, ``data_len`` counts the
    block's bytes and ``pre_len`` [B] int32 (default P) the window's.
    Returns (out [B, O] int32 bytes, out_len [B] int32, ok [B] bool,
    aux [B, 2] int32): aux is (the first record's literal length, or the
    tail's where no match record was made; the tail's literal length), as
    JAX returns it (:986-995 there) for ``VectorEncoder._encode_big``'s
    boundary merge.
    """
    return _encode(sequence_records, x, data_len, D, O, S_cap, rcap,
                   hc_level, hc_tiers, P, pre_len)


def chain_records(u32, matched, off_all, mlen_all, end_abs, pre_len,
                  D: int, S_cap: int, P: int = 0, cu_rounds: int = 2):
    """``seq_kernel.sequence_records``' outputs (same arguments, same
    layout) by the JAX encoder's chain record path, its branch with
    ``fused`` on and the sequence megakernel off (:785-906 there): the
    chain's orbit from ``chain_kernel.mark_chain``, every token and record
    field gather through ``fused_gather.table_gather`` (one launch for
    the offsets and lengths, two a catch-up round, one for the merge's
    running sums and one for the merged records)."""
    return parse_records(u32, matched, off_all, mlen_all, end_abs, pre_len,
                         D, S_cap, P, cu_rounds,
                         lambda g: mark_chain(g, D),
                         lambda tables_bits, idx: table_gather(
                             [t for t, _ in tables_bits], idx,
                             [b for _, b in tables_bits]))


def encode_batch_chain(x, data_len, D: int, O: int, S_cap: int,
                       rcap: int = RCAP, hc_level: int = 0,
                       hc_tiers: str | None = None, P: int = 0,
                       pre_len=None):
    """``encode_batch_vectorized`` (same arguments and returns, the same
    bytes) with ``chain_records`` in place of ``sequence_records``."""
    return _encode(chain_records, x, data_len, D, O, S_cap, rcap, hc_level,
                   hc_tiers, P, pre_len)


def batch_shapes(max_len: int, P: int = 0):
    """(D, O, S_cap) of a batch whose longest block has ``max_len``
    bytes behind a prefix of P, as ``VectorEncoder.encode_batch`` sizes
    it (encode_vector.py:1081-1084 there)."""
    D = P + _cdiv(max_len + 1, CH) * CH
    O = _cdiv(maximum_output_length(D - P) + 1, CH) * CH
    S_cap = _cdiv(D // MINMATCH + 2, LANE) * LANE + LANE
    return D, O, S_cap


def window_rows(blocks, dictionary=None, zeros=np.zeros):
    """The rows of a batch as ``VectorEncoder.encode_batch`` lays them
    out (encode_vector.py:1076-1094 there): the window prefixes (one
    shared dictionary, written once into every row, or a list of one a
    block; each cut to its last 64 KB and right-aligned in the first P
    positions, ``decode_vector.prefix_windows``, P = 0 without one),
    each block from P on.  ``zeros(shape, dtype)`` makes the rows, which
    need not be zero-filled: every byte is laid (``VectorEncoder`` hands
    its kept buffer's ``HostRows.empty``).  Returns (x [B, D] uint8,
    data_len [B] int32, pre_len [B] int32 or None, P, D, O, S_cap)."""
    B = len(blocks)
    with span("lz4t.encode.window") if dictionary else nullcontext():
        windows, pre_len, P = (prefix_windows(dictionary, B) if dictionary
                               else (None, None, 0))
        D, O, S_cap = batch_shapes(max(map(len, blocks)), P)
        x = zeros((B, D), np.uint8)
        if dictionary:
            lay_windows(x, windows, P)
    lay(x, blocks, at=P)
    data_len = np.array([len(b) for b in blocks], np.int32)
    return x, data_len, pre_len, P, D, O, S_cap


SEG_SIZE = 64 * 1024     # a big block's encode segments


def big_segments(blocks):
    """(block index, start, length) of each 64 KB segment of each block,
    in order."""
    return [(j, s, min(SEG_SIZE, len(b) - s)) for j, b in enumerate(blocks)
            for s in range(0, len(b), SEG_SIZE)]


def segment_rows(blocks, segs, dictionary=None):
    """The P-mode rows of ``VectorEncoder._encode_big`` (:1137-1158
    there) for the segments ``segs`` of ``big_segments(blocks)``: each
    segment from P = 65,536 on, behind the 64 KB of its block before it
    (for a segment less than 64 KB in, the dictionary's tail and the
    block's start), right-aligned below P.  Returns (x [n, D] uint8,
    data_len [n] int32, pre_len [n] int32, P, D, O, S_cap), D = 139,264
    whatever the segments' lengths, so every pass has one shape."""
    P = MAX_DISTANCE_WINDOW
    D, O, S_cap = batch_shapes(SEG_SIZE, P)
    with span("lz4t.encode.window"):
        head = bytes(dictionary)[-P:] if dictionary else b""
        windows = [(head + blocks[i][:s])[-P:] if s < P else blocks[i][s - P:s]
                   for i, s, _ in segs]
        pre_len = np.array([len(w) for w in windows], np.int32)
        x = lay(np.empty((len(segs), D), np.uint8), windows, end=P)
    lay(x, [blocks[i][s:s + ln] for i, s, ln in segs], at=P)
    lens = np.array([ln for *_, ln in segs], np.int32)
    return x, lens, pre_len, P, D, O, S_cap


def hc_rcap(hc_level: int, D: int) -> int:
    """Far matches extended past 8 bytes per block at a (clamped) level:
    RCAP for fast mode, D // 8 (at least RCAP) up to level 5, D // 4
    above (encode_vector.py:1096-1098 there)."""
    if hc_level == 0:
        return RCAP
    return max(RCAP, D // (8 if hc_level <= 5 else 4))


class VectorEncoder:
    """Fast and fast-HC batch encode through the kernels, one device pass
    per batch (and one for the segments of its blocks over 96 KB);
    blocks the device flags go to the host compressor."""

    MAX_BLOCK = 96 * 1024
    SEG_ROWS = 256           # segment rows at most in one device pass

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.host_encodes = 0
        self.window_bytes = 0       # window positions laid into rows
        # the small rows' kept buffer; the segment rows of big blocks,
        # laid and passed while the small rows wait, take fresh memory
        self._rows = HostRows()

    def _device_pass(self, x, lens, pre_len, P, D, O, S_cap, lvl,
                     hc_tiers):
        """``encode_batch_vectorized`` on rows laid out on the host:
        (out [B, O] uint8, out_len, ok, aux) as numpy arrays."""
        with span("lz4t.encode.upload"):
            xt, lt, pt = upload(self.device, x, lens, pre_len, widen=True)
        with span("lz4t.encode.pass"):
            out, out_len, ok, aux = encode_batch_vectorized(
                xt, lt, D, O, S_cap, hc_rcap(lvl, D), lvl, hc_tiers, P, pt)
        with span("lz4t.encode.fetch"):
            return fetch(out, out_len, ok, aux)

    def encode_batch(self, blocks, dst_maxlens=None, hc_level=0,
                     dictionary=None, hc_tiers=None):
        """Compressed payloads of ``blocks``; b"" for one longer than its
        ``dst_maxlens`` entry (default: the worst-case bound).
        ``hc_level`` 0 is fast greedy, 1-9 fast-HC (clamped to 9).
        ``dictionary`` enables preset-dictionary matching: its last 64 KB
        precede every block (P mode); decode needs the same bytes.
        Blocks over 96 KB encode as 64 KB segments (``_encode_big``)."""
        with span("lz4t.encode.batch"):
            with span("lz4t.encode.layout"):
                blocks = [bytes(b) for b in blocks]
                if not blocks:
                    return []
                if dst_maxlens is None:
                    dst_maxlens = [maximum_output_length(len(b))
                                   for b in blocks]
                big = [i for i, b in enumerate(blocks)
                       if len(b) > self.MAX_BLOCK]
                todo = [i for i, b in enumerate(blocks)
                        if b and len(b) <= self.MAX_BLOCK]
                laid = (window_rows([blocks[i] for i in todo], dictionary,
                                    self._rows.empty) if todo else None)
                if laid:
                    self.window_bytes += len(todo) * laid[3]
            lvl = min(max(hc_level, 0), 9)
            results = [b""] * len(blocks)   # an empty block encodes to b""
            if big:
                self._encode_big(big, blocks, dst_maxlens, results, lvl,
                                 dictionary, hc_tiers)
            if not todo:
                return results
            out, out_len, ok, _aux = self._device_pass(*laid, lvl, hc_tiers)
            with span("lz4t.encode.unpack"):
                for j, i in enumerate(todo):
                    if ok[j]:
                        payload = out[j, :int(out_len[j])].tobytes()
                    else:
                        self.host_encodes += 1
                        payload = self._host_encode(blocks[i], dst_maxlens[i],
                                                    lvl, dictionary)
                    results[i] = (payload if len(payload) <= dst_maxlens[i]
                                  else b"")
            return results

    def _encode_big(self, idx, blocks, dst_maxlens, results, lvl,
                    dictionary, hc_tiers):
        """Encode ``blocks[i]`` for i in ``idx`` (blocks over 96 KB) into
        ``results[i]`` (``_encode_big`` there, :1120-1212): each block is
        cut into 64 KB segments, each encoded in P mode behind the 64 KB
        of input before it (``segment_rows``), the segments of every big
        block in one device pass (of at most ``SEG_ROWS`` rows); the
        payloads join into one block, each segment's literal tail merged
        into the next segment's first literal run (a literal-only
        sequence may only end a block).  A block any of whose segments
        the device flags goes whole to the host compressor."""
        segs = big_segments([blocks[i] for i in idx])
        ok, aux, payloads = [], [], []
        for r0 in range(0, len(segs), self.SEG_ROWS):
            with span("lz4t.encode.layout"):
                laid = segment_rows([blocks[i] for i in idx],
                                    segs[r0:r0 + self.SEG_ROWS], dictionary)
                self.window_bytes += len(laid[1]) * laid[3]
            o, ol, k, a = self._device_pass(*laid, lvl, hc_tiers)
            with span("lz4t.encode.unpack"):
                payloads += [o[j, :n].tobytes() for j, n in enumerate(ol)]
                ok += k.tolist()
                aux += a.tolist()
        with span("lz4t.encode.unpack"):
            j0 = 0
            for i in idx:
                rows = range(j0, j0 + -(-len(blocks[i]) // SEG_SIZE))
                j0 = rows.stop
                if all(ok[j] for j in rows):
                    payload = self._merge_segments(
                        blocks[i], [(payloads[j], aux[j]) for j in rows])
                else:
                    self.host_encodes += 1
                    payload = self._host_encode(blocks[i], dst_maxlens[i],
                                                lvl, dictionary)
                results[i] = (payload if len(payload) <= dst_maxlens[i]
                              else b"")

    @staticmethod
    def _merge_segments(block, parts):
        """One block from its segments' payloads and aux pairs (:1170-1210
        there): a literal-only segment carries its bytes into the next;
        every other non-final segment's literal tail is stripped and
        joined to the next segment's first literal run, whose token keeps
        its match nibble; a pending tail at the end becomes a final
        literal-only sequence."""
        def lit_hdr(ll):
            return 1 + (0 if ll < 15 else 1 + (ll - 15) // 255)

        out = []
        pending = 0                     # carried literal bytes
        n = len(block)
        for j, (pl, (first_ll, tail_ll)) in enumerate(parts):
            sg = j * SEG_SIZE
            ln = min(SEG_SIZE, n - sg)
            if first_ll == ln and tail_ll == ln:
                pending += ln           # a literal-only segment
                continue
            if pending:
                h = lit_hdr(first_ll)
                tok_old = pl[0]
                lead = _synth_literals(block[sg - pending:sg]
                                       + pl[h:h + first_ll])
                # _synth_literals writes the match nibble 0: restore it
                pl = bytes([lead[0] | (tok_old & 15)]) + lead[1:] \
                    + pl[h + first_ll:]
            if j < len(parts) - 1:
                pl = pl[:len(pl) - (lit_hdr(tail_ll) + tail_ll)]
                pending = tail_ll
            else:
                pending = 0
            out.append(pl)
        if pending:                     # a trailing literal-only tail
            out.append(_synth_literals(block[n - pending:]))
        return b"".join(out)

    @staticmethod
    def _host_encode(block, dst_maxlen, hc_level, dictionary):
        """A flagged block on the native host engine (encode_vector.py:
        1214-1226 there), with the whole dictionary as given."""
        if dictionary:
            if hc_level:
                return native.compress_block_hc_dict(dictionary, block,
                                                     dst_maxlen)
            return native.compress_block_dict(dictionary, block, dst_maxlen)
        if hc_level:
            return native.compress_block_hc(block, dst_maxlen)
        return native.compress_block(block)
