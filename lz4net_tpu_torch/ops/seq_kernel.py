"""Greedy parse and sequence records (encode E3 + E4).

Port of the TPU kernel ``lz4net_tpu/ops/seq_kernel.py:
sequence_records``.  The CUDA kernel is ``csrc/seq_kernel.cu`` (its
header says what bounds it on the H100 and what the design does about
that); ``sequence_records_reference`` is its plain PyTorch version, a
port of the XLA stages E3-E5 of ``encode_vector._encode_batch_traced``.
Those stages are ``parse_records``, which takes the chain's orbit and
the field gathers as arguments: the plain version passes plain PyTorch
ones, ``encode_vector.chain_records`` (the chain record path) the
kernels ``chain_kernel.mark_chain`` and ``fused_gather.table_gather``.

From per-position (matched, off, mlen):

1. the greedy parse: the tokens are the matched positions on the chain
   from position 0, where a matched position steps to the first match at
   or after its end and any other to the first match at or after it;
2. token slots in position order (the first ``S_cap``), each with its
   literal run (from the previous token's match end, ``P`` for the
   first);
3. catch-up: each match extends backwards over equal bytes of its
   literal run, ``cu_rounds`` rounds of 4 bytes;
4. contiguous matches of one offset with no literals between them merge;
5. a final literal-only record at slot ``n_m`` (the block's tail), then
   per-record sizes and output starts ``s0``.

Outputs are the emit kernel's operands, over ``slot_width(S_cap)``
slots: (s0k, lit_src, lit_len, off, mlen) [B, SR] int32, dead slots
with ``s0k = BIGKEY`` and zeros, and stats [B, 8] int32: (n_seqs, n_m,
out_len, first record's literal length, tail literal length, tail
start, 0, 0).  Slots at or beyond ``S_cap`` are always dead; a block
with ``n_seqs >= S_cap`` or ``n_m >= S_cap`` overflowed and must be
encoded another way.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import MINMATCH, ML_MASK, RUN_MASK
from .emit_kernel import BIGKEY
from .parse_kernel import _orbit_of_zero

TILE = 4096          # the kernel's scan tile; D must be a multiple
MAX_D = 21 * 8192    # a 96 KB block behind a 64 KB window, the widest
                     # row the encoder makes

launches = 0


def slot_width(S_cap: int) -> int:
    """Slots of the outputs: S_cap rounded up to a multiple of 8192, as
    the TPU kernel pads its slot rows."""
    return -(-S_cap // 8192) * 8192


def _check(u32, matched, off_all, mlen_all, end_abs, pre_len, D, S_cap):
    for t in (u32, matched, off_all, mlen_all, end_abs, pre_len):
        if t.dtype != torch.int32 or t.device != u32.device:
            raise TypeError("all inputs must be int32 on one device")
    B = u32.shape[0]
    if D % TILE or D > MAX_D or any(t.shape != (B, D) for t in (
            u32, matched, off_all, mlen_all)):
        raise ValueError(f"u32/matched/off/mlen must be [B, D], "
                         f"D % {TILE} == 0, D <= {MAX_D}")
    if end_abs.shape != (B,) or pre_len.shape != (B,):
        raise ValueError("end_abs and pre_len must be [B]")
    if not 0 < S_cap <= D:
        raise ValueError("S_cap must be in [1, D]")


def sequence_records(u32, matched, off_all, mlen_all, end_abs, pre_len,
                     D: int, S_cap: int, P: int = 0, cu_rounds: int = 2):
    """u32/matched/off_all/mlen_all: [B, D] int32 (matched 0/1);
    end_abs/pre_len: [B] int32.  Returns (s0k, lit_src, lit_len, off,
    mlen, stats)."""
    global launches
    _check(u32, matched, off_all, mlen_all, end_abs, pre_len, D, S_cap)
    if u32.device.type == "cpu":
        return sequence_records_reference(u32, matched, off_all, mlen_all,
                                          end_abs, pre_len, D, S_cap, P,
                                          cu_rounds)
    if u32.device.type != "cuda":
        raise ValueError(f"unsupported device {u32.device}")
    ins = [t.contiguous() for t in (u32, matched, off_all, mlen_all,
                                    end_abs, pre_len)]
    B = u32.shape[0]
    SR = slot_width(S_cap)
    outs = [torch.empty((B, SR), dtype=torch.int32, device=u32.device)
            for _ in range(5)]
    stats = torch.empty((B, 8), dtype=torch.int32, device=u32.device)
    slots = torch.empty((B, 4, S_cap), dtype=torch.int32,
                        device=u32.device)
    _build.launch("lz4t_sequence_records", u32.device,
                  *(t.data_ptr() for t in ins),
                  *(t.data_ptr() for t in outs), stats.data_ptr(),
                  slots.data_ptr(), B, D, S_cap, SR, P, cu_rounds)
    launches += 1
    return (*outs, stats)


def xor_match_bytes_rev(wa, wb):
    """Number of equal high-order bytes of two u32 words (0..4)."""
    diff = wa ^ wb
    return torch.where(
        (diff & -16777216) != 0, 0,
        torch.where((diff & 0xFF0000) != 0, 1,
                    torch.where((diff & 0xFF00) != 0, 2,
                                torch.where(diff != 0, 3, 4)))
    ).to(torch.int32)


def _next_match_at_or_after(m, D: int):
    """nm[b, i] = the first j >= i with m[b, j], else D (``encode_vector.
    _next_match_at_or_after`` there)."""
    i = torch.arange(D, dtype=torch.int32, device=m.device)
    return torch.flip(torch.cummin(torch.flip(torch.where(m, i, D), [1]),
                                   dim=1).values, [1])


def compact_indices(mask, cap: int, big: int):
    """The positions of ``mask [B, N]``'s set entries in ascending order,
    the first ``cap`` of them, padded with ``big``: [B, cap] int32
    (``banded.compact_indices`` there)."""
    B, N = mask.shape
    rank = torch.cumsum(mask, 1, dtype=torch.int32) - 1
    dst = torch.where(mask & (rank < cap), rank, cap).long()
    i = torch.arange(N, dtype=torch.int32, device=mask.device).expand(B, N)
    return torch.full((B, cap + 1), big, dtype=torch.int32,
                      device=mask.device).scatter_(1, dst, i)[:, :cap]


def chain_graph(m, mlen_all, D: int):
    """g[b, i]: the next token position if a token is taken at i (the
    first match at or after the end of i's match where ``m`` [B, D] bool
    is set, else the first match at or after i), at least i + 1 and at
    most D."""
    i = torch.arange(D, dtype=torch.int32, device=m.device)
    nm = _next_match_at_or_after(m, D)
    tgt = i + torch.where(m, mlen_all.clamp(0, D), 1)
    nm_at_end = torch.where(tgt >= D, D, torch.gather(
        nm, 1, tgt.clamp(0, D - 1).long()))
    return torch.maximum(torch.where(m, nm_at_end, nm), i + 1)


def _orbit(g):
    """The orbit of 0 under g [B, D] (g <= D), by doubling."""
    B, D = g.shape
    end = torch.full((B, 1), D, dtype=g.dtype, device=g.device)
    return _orbit_of_zero(torch.cat([g, end], 1))[:, :D]


def _gather(tables_bits, idx):
    """Each table at ``idx`` (in range; the widths are not needed)."""
    return [torch.gather(t, 1, idx.long()) for t, _ in tables_bits]


def sequence_records_reference(u32, matched, off_all, mlen_all, end_abs,
                               pre_len, D: int, S_cap: int, P: int = 0,
                               cu_rounds: int = 2):
    """Plain PyTorch version of ``sequence_records`` (same outputs)."""
    return parse_records(u32, matched, off_all, mlen_all, end_abs, pre_len,
                         D, S_cap, P, cu_rounds, _orbit, _gather)


def parse_records(u32, matched, off_all, mlen_all, end_abs, pre_len,
                  D: int, S_cap: int, P: int, cu_rounds: int, orbit,
                  gather):
    """``sequence_records``' outputs by the XLA stages E3-E5 of
    ``encode_vector._encode_batch_traced`` there (:785-906), with the
    chain's orbit from ``orbit(g)`` ([B, D] 0/1) and every gather of a
    token or record field from ``gather([(table, bits), ...], idx)``
    (a list of tables at ``idx``, whose entries are in range)."""
    i32 = torch.int32
    dev = u32.device
    B = u32.shape[0]
    k = torch.arange(S_cap, dtype=i32, device=dev).expand(B, S_cap)
    m = matched == 1

    # ---- E3: the greedy parse chain and its orbit from position 0 ----
    mark = (orbit(chain_graph(m, mlen_all, D)) == 1) & m
    n_seqs = mark.sum(1, dtype=i32)

    # ---- E4: token slots, literal runs ----------------------------------
    tok = compact_indices(mark, S_cap, D)
    valid = tok < D
    tok = tok.clamp(0, D - 1)
    off_s, mlen_s = gather([(off_all, 17), (mlen_all, 17)], tok)
    off_s = torch.where(valid, off_s, 0)
    mlen_s = torch.where(valid, mlen_s, 0)
    prev_end = torch.cat([torch.full((B, 1), P, dtype=i32, device=dev),
                          (tok + mlen_s)[:, :-1]], 1)
    lit_start = torch.where(valid, prev_end, 0)
    lit_len = torch.where(valid, tok - lit_start, 0)

    # catch-up: extend each match backwards over its literal run; the
    # match end, and so the parse, is unchanged
    cb = torch.zeros_like(tok)
    can = valid & (mlen_s > 0)
    floor_abs = P - pre_len[:, None]         # lowest legal match source
    for _ in range(cu_rounds):
        cb_max = torch.minimum(lit_len, tok - off_s - floor_abs)
        pa = tok - cb - 4
        pb = tok - off_s - cb - 4
        (wa,) = gather([(u32, 32)], pa.clamp(0, D - 1))
        (wb,) = gather([(u32, 32)], pb.clamp(0, D - 1))
        nb = torch.where(can & (pa >= 0) & (pb >= 0),
                         xor_match_bytes_rev(wa, wb), 0)
        cb = torch.minimum(cb + nb, cb_max.clamp(min=0))
        can = can & (nb == 4)
    lit_len = lit_len - torch.where(valid, cb, 0)
    mlen_s = mlen_s + torch.where(valid, cb, 0)

    # merge contiguous same-offset matches
    prev_off = torch.cat([torch.zeros_like(off_s[:, :1]), off_s[:, :-1]],
                         1)
    is_start = ~valid | (k == 0) | (lit_len != 0) | (off_s != prev_off)
    mcum = torch.cumsum(mlen_s, 1, dtype=i32)
    start_next = torch.cat([torch.where(is_start[:, 1:], k[:, 1:], S_cap),
                            torch.full((B, 1), S_cap, dtype=i32,
                                       device=dev)], 1)
    nxt = torch.flip(torch.cummin(torch.flip(start_next, [1]), dim=1)
                     .values, [1])
    last = (nxt - 1).clamp(0, S_cap - 1)
    (mcum_last,) = gather([(mcum, 21)], last)
    merged = mcum_last - (mcum - mlen_s)

    keep = is_start & valid
    n_m = keep.sum(1, dtype=i32)
    kidx = compact_indices(keep, S_cap, S_cap)
    valid_m = kidx < S_cap
    lit_start, lit_len, off_m, mlen_m = (
        torch.where(valid_m, v, 0) for v in gather(
            [(torch.where(keep, f, 0), 17)
             for f in (lit_start, lit_len, off_s, merged)],
            kidx.clamp(0, S_cap - 1)))

    # final literal-only record at slot n_m (the LASTLITERALS tail)
    tail_start = torch.where(valid_m, lit_start + lit_len + mlen_m, 0) \
        .amax(1).clamp(min=P)
    tail_len = end_abs - tail_start
    is_final = k == n_m[:, None]
    lit_start = torch.where(is_final, tail_start[:, None], lit_start)
    lit_len = torch.where(is_final, tail_len[:, None], lit_len)
    off_m = torch.where(is_final, 0, off_m)
    mlen_m = torch.where(is_final, 0, mlen_m)
    live = valid_m | is_final
    has_match = live & (mlen_m > 0)

    # ---- E5 prep: record sizes and output starts -----------------------
    e_lit = (lit_len - RUN_MASK).clamp(min=0)
    lit_ext = torch.where(live & (lit_len >= RUN_MASK), 1 + e_lit // 255,
                          0)
    e_m = (mlen_m - MINMATCH - ML_MASK).clamp(min=0)
    m_ext = torch.where(has_match & (mlen_m - MINMATCH >= ML_MASK),
                        1 + e_m // 255, 0)
    size = torch.where(live, 1 + lit_ext + lit_len
                       + torch.where(has_match, 2 + m_ext, 0), 0)
    scum = torch.cumsum(size, 1, dtype=i32)

    pad = slot_width(S_cap) - S_cap

    def out(v, dead):
        v = torch.where(live, v, dead).to(i32)
        return torch.nn.functional.pad(v, (0, pad), value=dead)

    lit_len_o = out(lit_len, 0)
    stats = torch.stack([n_seqs, n_m, scum[:, -1], lit_len_o[:, 0],
                         tail_len, tail_start, torch.zeros_like(n_m),
                         torch.zeros_like(n_m)], 1).to(i32)
    return (out(scum - size, BIGKEY), out(lit_start, 0), lit_len_o,
            out(off_m, 0), out(torch.where(has_match, mlen_m, 0), 0),
            stats)
