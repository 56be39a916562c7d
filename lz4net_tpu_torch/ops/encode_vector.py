"""Batched fast greedy encode of independent LZ4 blocks on the card.

Port of the fast path of ``lz4net_tpu/ops/encode_vector.py``
(``encode_batch_vectorized(fused=True)`` with ``hc_level=0`` and no
dictionary, :499-548 and :759-783) and of ``VectorEncoder.encode_batch``
for blocks of at most 96 KB.  Four kernels carry it, each with its plain
PyTorch version beside it, and a fifth serves the literal bytes:

1. ``hash_kernel.bucket_prev``: each position's match candidate;
2. ``mlen_kernel.match_lengths_fused``: match lengths and the format's
   end rules;
3. ``seq_kernel.sequence_records``: greedy parse, catch-up, merge and
   the per-record output starts;
4. ``emit_kernel.emit_bytes``: every compressed byte, or the input index
   of a literal;
5. ``fused_gather.rowbase_gather`` (the decode path's gather): the
   literal bytes.

The output is the JAX vector encoder's byte string exactly: format-valid
LZ4 that any decoder reads, not the reference compressor's parse.  A
block the device flags goes to the host compressor
(``models.reference.compress_block``); ``VectorEncoder.host_encodes``
counts those blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_DISTANCE, MINMATCH, maximum_output_length
from ..models import reference
from .decode_vector import CH, _cdiv, resolve_device
from .emit_kernel import emit_bytes
from .fused_gather import rowbase_gather
from .hash_kernel import bucket_prev, hash_bucket, hash_bucket8
from .mlen_kernel import match_lengths_fused
from .seq_kernel import sequence_records

LANE = 128
TOP_OFFSETS = 8      # dominant offsets given exact unbounded lengths
SUB_STEP = 16        # the offset stream is sampled every SUB_STEP bytes
CU_ROUNDS = 2        # catch-up rounds of the fast mode
RCAP = 4096          # far matches extended past 8 bytes, per block


def _shift_left(w, n):
    """y[:, i] = w[:, i + n], zero past the end."""
    return torch.cat([w[:, n:], torch.zeros_like(w[:, :n])], dim=1)


def _u32(x):
    """u32[i] = little-endian 4-byte word at i (zero-padded tail), as
    int32 (computed in int64, so the top byte's shift cannot overflow)."""
    x = x.long()
    w = x | (_shift_left(x, 1) << 8) | (_shift_left(x, 2) << 16) \
        | (_shift_left(x, 3) << 24)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _top_offsets_select(off, far):
    """The TOP_OFFSETS most frequent far offsets of the offset stream
    sampled every SUB_STEP bytes, ties to the smaller offset
    (``jax.lax.top_k`` keeps the lower index first; a stable descending
    sort does the same).  Returns dks [B, TOP_OFFSETS] int32 (0 marks an
    unused slot)."""
    sv = torch.sort(torch.where(far[:, ::SUB_STEP], off[:, ::SUB_STEP], 0),
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
        .indices[:, :TOP_OFFSETS]
    dks = torch.gather(sv, 1, ti) * (torch.gather(cnt, 1, ti) > 0)
    return dks.to(torch.int32)


def encode_batch_vectorized(x, data_len, D: int, O: int, S_cap: int,
                            rcap: int = RCAP):
    """Greedy-encode a batch of independent blocks.

    x: [B, D] int32 bytes (zero padded), data_len: [B] int32,
    D % 8192 == 0, O >= maximum_output_length(D) the padded output
    width, S_cap the record cap (D // 4 + a margin never overflows).
    Returns (out [B, O] int32 bytes, out_len [B] int32, ok [B] bool).
    """
    # no dictionary prefix in this slice: P = 0, pre_len = 0
    pre_len = torch.zeros_like(data_len)
    u32 = _u32(x)
    u32s4 = _shift_left(u32, 4)
    prev = bucket_prev(u32, u32s4, hash_bucket(u32),
                       hash_bucket8(u32, u32s4), D)

    i = torch.arange(D, dtype=torch.int32, device=x.device)
    off = i - prev
    far = (prev >= 0) & (off <= MAX_DISTANCE) & (off > 4)
    dks = _top_offsets_select(off, far)
    m8 = torch.zeros_like(prev)        # no 8-byte-verified candidates
    matched, off_all, mlen_all = match_lengths_fused(
        x, u32, prev, m8, dks, data_len, data_len, D, rcap)

    s0k, lit_src, lit_len, off_k, mlen_k, stats = sequence_records(
        u32, matched, off_all, mlen_all, data_len, pre_len, D, S_cap,
        P=0, cu_rounds=CU_ROUNDS)
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


def batch_shapes(max_len: int):
    """(D, O, S_cap) of a batch whose longest block has ``max_len``
    bytes, as ``VectorEncoder.encode_batch`` sizes it
    (encode_vector.py:1081-1084 there)."""
    D = _cdiv(max_len + 1, CH) * CH
    O = _cdiv(maximum_output_length(D) + 1, CH) * CH
    S_cap = _cdiv(D // MINMATCH + 2, LANE) * LANE + LANE
    return D, O, S_cap


class VectorEncoder:
    """Fast greedy batch encode through the four kernels, one device
    pass per batch; blocks the device flags go to the host compressor."""

    MAX_BLOCK = 96 * 1024

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.host_encodes = 0

    def encode_batch(self, blocks, dst_maxlens=None, hc_level=0,
                     dictionary=None):
        """Compressed payloads of ``blocks``; b"" for one longer than its
        ``dst_maxlens`` entry (default: the worst-case bound)."""
        if hc_level:
            raise NotImplementedError(
                "fast-HC encode (hc_level > 0) is not ported yet: "
                "ROADMAP.md queue A, item 6")
        if dictionary:
            raise NotImplementedError(
                "preset-dictionary encode is not ported yet: ROADMAP.md "
                "queue A, item 7")
        blocks = [bytes(b) for b in blocks]
        if not blocks:
            return []
        if dst_maxlens is None:
            dst_maxlens = [maximum_output_length(len(b)) for b in blocks]
        big = [i for i, b in enumerate(blocks) if len(b) > self.MAX_BLOCK]
        if big:
            raise NotImplementedError(
                f"blocks over {self.MAX_BLOCK} bytes (indices {big[:8]}) "
                "are not ported yet: ROADMAP.md queue A, item 7")
        results = [b""] * len(blocks)      # an empty block encodes to b""
        todo = [i for i, b in enumerate(blocks) if b]
        if not todo:
            return results
        D, O, S_cap = batch_shapes(max(len(blocks[i]) for i in todo))
        x = np.zeros((len(todo), D), np.uint8)
        for j, i in enumerate(todo):
            x[j, :len(blocks[i])] = np.frombuffer(blocks[i], np.uint8)
        lens = np.array([len(blocks[i]) for i in todo], np.int32)
        # the bytes ship as uint8 and widen on the device
        xt = torch.from_numpy(x).to(self.device).to(torch.int32)
        out, out_len, ok = encode_batch_vectorized(
            xt, torch.from_numpy(lens).to(self.device), D, O, S_cap)
        # fetch bytes, not words
        out = out.to(torch.uint8).cpu().numpy()
        out_len, ok = out_len.cpu().numpy(), ok.cpu().numpy()
        for j, i in enumerate(todo):
            if ok[j]:
                payload = out[j, :int(out_len[j])].tobytes()
            else:
                self.host_encodes += 1
                payload = reference.compress_block(blocks[i])
            results[i] = payload if len(payload) <= dst_maxlens[i] else b""
        return results
