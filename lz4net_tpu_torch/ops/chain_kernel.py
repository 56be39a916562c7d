"""The greedy parse's chain: the orbit of position 0 (encode E3).

Port of the TPU kernel ``lz4net_tpu/ops/chain_kernel.py: mark_chain``.
``g[b, i]`` is the next token position if a token is taken at i; the
parse's tokens are the orbit of 0.  The CUDA kernel is
``csrc/chain_kernel.cu``: a CTA a block finds every position's exit from
its 32-position segment and 128-position group by warp-wide pointer
doubling, one warp hops over the group exits (one shared-memory read a
group the orbit enters, not one a position as the first form's single
walking thread did), and the worker warps mark each segment from its
entry; its header says what bounds it on the H100.
``mark_chain_reference`` is its plain PyTorch version, a batched walk.

Both mark the exact orbit on every int32 ``g``.  The TPU kernel stops
its in-segment marking after 44 rounds, which covers the encoder's
graphs but leaves positions unmarked on a graph such as ``g[i] = i + 1``.
"""

from __future__ import annotations

import torch

from .. import _build

MAX_D = 13 * 8192    # 96 KB blocks

launches = 0


def mark_chain(g, D: int):
    """g: [B, D] int32 with g[i] > i and g[i] <= D.  Returns mark [B, D]
    int32, 1 on the orbit of 0 under g.  A step with g[i] <= i ends the
    walk at i (junk-safe), one to D or past it ends it after i."""
    global launches
    if g.dtype != torch.int32 or g.dim() != 2 or g.shape[1] != D:
        raise TypeError("g must be [B, D] int32")
    if not 0 < D <= MAX_D:
        raise ValueError(f"D must be in [1, {MAX_D}]")
    if g.device.type == "cpu":
        return mark_chain_reference(g, D)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    g = g.contiguous()
    mark = torch.empty_like(g)
    _build.launch("lz4t_mark_chain", g.device, g.data_ptr(),
                  mark.data_ptr(), g.shape[0], D)
    launches += 1
    return mark


def mark_chain_reference(g, D: int):
    """Plain PyTorch version of ``mark_chain``: every row walks one step
    a round until each has passed D or stopped."""
    B = g.shape[0]
    mark = torch.zeros_like(g)
    rows = torch.arange(B, device=g.device)
    pos = torch.zeros(B, dtype=torch.long, device=g.device)
    live = torch.ones(B, dtype=torch.bool, device=g.device)
    while bool(live.any()):
        mark[rows[live], pos[live]] = 1
        nxt = g.gather(1, pos.clamp(max=D - 1)[:, None])[:, 0].long()
        live &= nxt > pos
        pos = torch.where(live, nxt, pos)
        live &= pos < D
    return mark
