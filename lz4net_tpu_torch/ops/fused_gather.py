"""Gather from a per-block table: vals[b, k] = table[b, idx[b, k]].

Port of the TPU kernel ``lz4net_tpu/ops/fused_gather.py:
rowbase_gather``.  The TPU version serves a near-monotone index stream
from a window of ``w_rows`` rows of one or more tables, because the TPU
has no gather; Hopper gathers natively, so the CUDA kernel
``csrc/fused_gather.cu`` reads every entry of the one table the decode
path gathers from exactly, and takes no window parameters.  ``in_band``
is True where the index lies in [0, N) (an index outside reads the
clamped entry).  ``rowbase_gather_reference`` is the plain PyTorch
version.
"""

from __future__ import annotations

import torch

from .. import _build

launches = 0


def rowbase_gather(table, idx):
    """table: [B, N] int32; idx: [B, K] int32.
    Returns (vals [B, K] int32, in_band [B, K] bool)."""
    global launches
    for t in (table, idx):
        if t.dtype != torch.int32 or t.dim() != 2 or t.device != idx.device:
            raise TypeError("table and idx must be 2-D int32 on one device")
    if table.shape[0] != idx.shape[0]:
        raise ValueError("table must be [B, N] and idx [B, K]")
    if idx.device.type == "cpu":
        return rowbase_gather_reference(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    table, idx = table.contiguous(), idx.contiguous()
    B, K = idx.shape
    vals = torch.empty_like(idx)
    in_band = torch.empty((B, K), dtype=torch.bool, device=idx.device)
    _build.launch("lz4t_rowbase_gather", idx.device, table.data_ptr(),
                  idx.data_ptr(), vals.data_ptr(), in_band.data_ptr(),
                  B, table.shape[1], K)
    launches += 1
    return vals, in_band


def rowbase_gather_reference(table, idx):
    """Plain PyTorch version of ``rowbase_gather``."""
    vals = torch.gather(table, 1, idx.clamp(0, table.shape[1] - 1).long())
    in_band = (idx >= 0) & (idx < table.shape[1])
    return vals, in_band
