"""Token parse: compressed bytes -> token marks and lengths.

Port of the TPU kernel ``lz4net_tpu/ops/parse_kernel.py: parse_tokens``.
The CUDA kernel is ``csrc/parse_kernel.cu`` (its header says what bounds
it on the H100 and what the design does about that);
``parse_tokens_reference`` is its plain PyTorch version, used for CPU
tensors and as the kernel's yardstick on the card.

Per position q of a block (only marked positions are meaningful):
``lit_len`` and ``mlen`` of a token starting at q, by the speculative
parse formulas of ``parse_kernel.py:86-119``; ``mark`` is the orbit of
position 0 under the chain pointer ``g = clip(mpos + 2 + mext, q + 3,
C - 1)``, below ``comp_len``.  Window misses cannot happen with exact
reads, so ``miss`` is always False.
"""

from __future__ import annotations

import torch

from .. import _build

TILE = 4096          # the kernel's scan tile; C must be a multiple
M17 = (1 << 17) - 1
BIG = 1 << 30

launches = 0


def _check(comp, comp_len, C):
    if comp.dtype != torch.int32 or comp_len.dtype != torch.int32:
        raise TypeError("comp and comp_len must be int32")
    if comp.dim() != 2 or comp.shape[1] != C or C % TILE:
        raise ValueError(f"comp must be [B, C] with C % {TILE} == 0")
    if comp_len.shape != (comp.shape[0],) or comp_len.device != comp.device:
        raise ValueError("comp_len must be [B] on comp's device")


def parse_tokens(comp, comp_len, C: int):
    """comp: [B, C] int32 bytes, comp_len: [B] int32.  Returns
    (mark, lit_len, mlen) [B, C] int32 and miss [B] bool."""
    global launches
    _check(comp, comp_len, C)
    if comp.device.type == "cpu":
        return parse_tokens_reference(comp, comp_len, C)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    comp, comp_len = comp.contiguous(), comp_len.contiguous()
    B = comp.shape[0]
    mark, lit_len, mlen = (torch.empty_like(comp) for _ in range(3))
    miss = torch.empty(B, dtype=torch.bool, device=comp.device)
    ext, g = torch.empty_like(comp), torch.empty_like(comp)
    _build.launch("lz4t_parse_tokens", comp.device, comp.data_ptr(),
                  comp_len.data_ptr(), mark.data_ptr(), lit_len.data_ptr(), mlen.data_ptr(),
                  miss.data_ptr(), ext.data_ptr(), g.data_ptr(), B, C)
    launches += 1
    return mark, lit_len, mlen, miss


def _orbit_of_zero(g):
    """mark[b, q] = 1 iff q = g^i(0) for some i >= 0, by doubling: after
    step k the marked set holds g^i(0) for i < 2^k and J = g^(2^k)."""
    B, C = g.shape
    J = g.long()
    mark = torch.zeros_like(g)
    mark[:, 0] = 1
    span = 1
    while span < C:
        mark = (mark + torch.zeros_like(mark).scatter_add_(1, J, mark)) > 0
        mark = mark.to(torch.int32)
        J = torch.gather(J, 1, J)
        span *= 2
    return mark


def parse_tokens_reference(comp, comp_len, C: int):
    """Plain PyTorch version of ``parse_tokens`` (same outputs)."""
    B = comp.shape[0]
    q = torch.arange(C, dtype=torch.int32, device=comp.device).expand(B, C)
    # run255[q]: length of the 0xFF run starting at q (suffix min of the
    # next non-255 index)
    nxt = torch.where(comp != 255, q, BIG)
    nn = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    run255 = (nn - q).clamp(0, C)
    term = torch.gather(comp, 1, (q + run255).clamp(0, C - 1).long())
    ext_val = (255 * run255 + term).clamp(0, M17)

    lit_nib = comp >> 4
    ml_nib = comp & 15
    # the literal-side extension starts at q+1 (zero past the end)
    ext_lit = torch.cat([ext_val[:, 1:], torch.zeros_like(ext_val[:, :1])],
                        dim=1)
    lit_len = torch.where(lit_nib == 15, 15 + ext_lit, lit_nib).clamp(0, M17)
    hdr = 1 + torch.where(lit_nib == 15, 1 + ext_lit // 255, 0)
    mpos = (q + hdr + lit_len).clamp(0, C - 1)
    mp2 = (mpos + 2).clamp(0, C - 1)
    ext_m = torch.gather(ext_val, 1, mp2.long()).clamp(0, M17)
    mlen = (4 + torch.where(ml_nib == 15, 15 + ext_m, ml_nib)).clamp(0, M17)
    mext = torch.where(ml_nib == 15, 1 + ext_m // 255, 0)
    g = torch.maximum(mpos + 2 + mext, q + 3).clamp(max=C - 1)

    mark = _orbit_of_zero(g) * (q < comp_len[:, None]).to(torch.int32)
    miss = torch.zeros(B, dtype=torch.bool, device=comp.device)
    return mark, lit_len, mlen, miss
