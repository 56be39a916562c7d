"""Batched known-length decode of independent LZ4 blocks on the card.

Port of the fused branch of ``lz4net_tpu/ops/decode_vector.py``
(``decode_batch_vectorized(fused=True)``, :304-374) and of
``VectorDecoder.decode_batch`` for blocks of at most 96 KB.  Four kernels
carry it, each with its plain PyTorch version beside it:

1. ``parse_kernel.parse_tokens``: compressed bytes -> token marks;
2. ``records_kernel.records_to_state``: marks -> per-byte state words and
   the hardened decoder's certificate;
3. ``fused_gather.rowbase_gather``: the literal byte of every output byte;
4. ``resolve_kernel.resolve_wavefront``: state words -> output bytes.

The kernels' gathers are exact, so the JAX decoder's sequence/event caps
and its second, dense-caps pass serve nothing here: one pass decodes
every block, and a block the device cannot certify is re-decoded by the
host oracle (``models.reference``), which raises ``CorruptedBlockError``
for malformed input.  ``VectorDecoder.host_decodes`` counts those blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import reference
from .fused_gather import rowbase_gather
from .parse_kernel import parse_tokens
from .records_kernel import records_to_state
from .resolve_kernel import resolve_wavefront

CH = 8192            # output padding / resolve chunk
BCH = 4096           # compressed-length padding
VFLAG = 1 << 19      # value-terminal flag in state words
BIASD = 1 << 18      # bound on the output domain Dt


def _cdiv(a, b):
    return -(-a // b)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def batch_from_numpy(comp, comp_len, out_len, device):
    """The port's tensors for one batch: comp [B, C] bytes (uint8, C a
    multiple of 4096) and comp_len/out_len [B] as numpy arrays, as the
    JAX ``_device_pass`` builds them.  The bytes ship as uint8 and widen
    to int32 on the device.  Returns (comp, comp_len, out_len) int32."""
    device = resolve_device(device)
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    if comp.ndim != 2 or comp.shape[1] % BCH:
        raise ValueError(f"comp must be [B, C] with C % {BCH} == 0")
    return (torch.from_numpy(comp).to(device).to(torch.int32),
            torch.from_numpy(np.asarray(comp_len, np.int32)).to(device),
            torch.from_numpy(np.asarray(out_len, np.int32)).to(device))


def pack_blocks(blocks, out_lens):
    """Host-side batch layout of ``_device_pass`` (decode_vector.py:
    709-728): (comp [B, C] uint8, comp_len [B], out_len [B], C, D)."""
    max_c = max(max(len(b) for b in blocks), 16)
    max_d = max(max(out_lens), 1)
    C = _cdiv(max_c + 1, BCH) * BCH
    D = _cdiv(max_d + 1, CH) * CH
    comp = np.zeros((len(blocks), C), np.uint8)
    for i, b in enumerate(blocks):
        comp[i, :len(b)] = np.frombuffer(b, np.uint8)
    comp_len = np.array([len(b) for b in blocks], np.int32)
    out_len = np.array(out_lens, np.int32)
    return comp, comp_len, out_len, C, D


def decode_batch_vectorized(comp, comp_len, out_len, C: int, D: int):
    """Decode a batch of independent known-length blocks.

    comp: [B, C] int32 bytes (zero padded), comp_len/out_len: [B] int32,
    C % 4096 == 0, D % 8192 == 0.  Returns (out [B, D] int32 bytes,
    total_out, ok, strict, consumed, needed), each [B]: the certificate
    of ``lz4net_tpu.ops.decode_vector.decode_batch_vectorized``.
    """
    if D % CH or D > BIASD:
        raise ValueError(f"D must be a multiple of {CH} and <= {BIASD}")
    # no dictionary prefix in this slice: P = 0, pre_len = 0, start_chunk 0
    pre_len = torch.zeros_like(comp_len)
    live_o = torch.arange(D, dtype=torch.int32,
                          device=comp.device)[None, :] < out_len[:, None]

    mark, lit_len, mlen, pmiss = parse_tokens(comp, comp_len, C)
    t0m, cidx, stats = records_to_state(comp, mark, lit_len, mlen, comp_len,
                                        out_len, pre_len, C, D, 0)
    total_out = stats[:, 1]
    strict = stats[:, 2] != 0
    consumed = stats[:, 3]
    needed = stats[:, 4]
    rk_miss = stats[:, 5] != 0

    is_lit_o = cidx >= 0
    lit_idx = torch.cummax(torch.where(is_lit_o, cidx.clamp(0, C - 1), 0),
                           dim=1).values
    vals0, band_l = rowbase_gather(comp, lit_idx)
    lit_miss = (~band_l & is_lit_o & live_o).any(1)
    T0 = torch.where(is_lit_o, VFLAG | (vals0 & 0xFF), t0m)
    out, res_ok = resolve_wavefront(T0, 0)
    out = out * live_o
    ok = ~rk_miss & ~lit_miss & res_ok & ~pmiss
    return out, total_out, ok, strict, consumed, needed


class VectorDecoder:
    """Known-length batch decode through the four kernels, one device
    pass per batch; uncertified blocks go to the host oracle."""

    MAX_BLOCK = 96 * 1024

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.host_decodes = 0

    def decode_batch(self, blocks, out_lens):
        blocks = [bytes(b) for b in blocks]
        out_lens = list(out_lens)
        if not blocks:
            return []
        big = [i for i, (b, n) in enumerate(zip(blocks, out_lens))
               if len(b) > self.MAX_BLOCK or n > self.MAX_BLOCK]
        if big:
            raise NotImplementedError(
                f"blocks over {self.MAX_BLOCK} bytes (indices {big[:8]}) "
                "are not ported yet: ROADMAP.md queue A, item 4")
        comp, comp_len, out_len, C, D = pack_blocks(blocks, out_lens)
        dev = batch_from_numpy(comp, comp_len, out_len, self.device)
        out, total, ok, strict, _consumed, needed = \
            decode_batch_vectorized(*dev, C, D)
        # fetch bytes, not words
        out = out.to(torch.uint8).cpu().numpy()
        total, ok = total.cpu().numpy(), ok.cpu().numpy()
        strict, needed = strict.cpu().numpy(), needed.cpu().numpy()
        results = []
        # Accept device output only under full strict certification (the
        # hardened-decoder invariants + exact length match), exactly the
        # rule of decode_vector.py:769-774; anything weaker could accept a
        # stream the reference rejects.
        for i, n in enumerate(out_lens):
            if (not bool(ok[i]) or int(total[i]) != n
                    or not bool(strict[i]) or int(needed[i]) != n):
                self.host_decodes += 1
                results.append(reference.decompress_block(blocks[i], n))
            else:
                results.append(out[i, :n].tobytes())
        return results
