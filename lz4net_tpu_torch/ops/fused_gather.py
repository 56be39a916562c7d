"""Gathers from per-block tables, the four of the TPU's fused gather
module ``lz4net_tpu/ops/fused_gather.py``:

* ``rowbase_gather``: vals[b, k] = table[b, idx[b, k]] (the decode path's
  literal bytes, and the encode paths');
* ``table_gather``: several tables at one index stream, each value kept
  to its low ``ceil(bits / 8)`` bytes (the chain record path of encode);
* ``lane_lookup``: a lookup within each 128-entry row;
* ``diag_gather``: a lookup whose index lies in a band of rows around the
  element's own row, with the band flag.

The TPU has no gather, so its kernels fetch rows with one-hot bf16
matmuls per 8-bit plane, shuffle lanes and select over row windows.
Hopper gathers natively: each CUDA kernel in ``csrc/fused_gather.cu``
reads its entries directly and reproduces what the TPU kernel returns on
every index, in range or not (``rowbase_gather`` alone takes no window
parameters: its ``in_band`` says whether the index lies in [0, N), and
an index outside reads the clamped entry).  Three take one thread an
element; ``table_gather``'s, whose table entries sit mostly in sectors of
their own, keeps four elements' loads of every table in flight a thread
over a grid the card holds at once (the file's header says why).  Each
has its plain PyTorch version beside it, ``*_reference``, and its own
launch counter.
"""

from __future__ import annotations

import torch

from .. import _build

LANE = 128

launches = 0         # rowbase_gather's kernel
table_launches = 0   # table_gather's
lane_launches = 0    # lane_lookup's
diag_launches = 0    # diag_gather's


def _int32_on(device, *ts):
    for t in ts:
        if t.dtype != torch.int32 or t.device != device:
            raise TypeError("tables and indices must be int32 on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


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


def _byte_mask(bits: int) -> int:
    """The low ceil(bits / 8) bytes as an int32 mask (-1 for all four)."""
    if not 1 <= bits <= 32:
        raise ValueError("bits must be in [1, 32]")
    nbytes = -(-bits // 8)
    return -1 if nbytes == 4 else (1 << (8 * nbytes)) - 1


def table_gather(tables, idx, bits):
    """out[t][b, k] = tables[t][b, j] & mask(bits[t]), where j is row
    clamp(idx >> 7, 0, N / 128 - 1), lane idx & 127: the TPU kernel's
    value on every index (an index in [0, N) reads its entry).

    tables: 1-4 [B, N] int32, N % 128 == 0; idx: [B, K] int32; bits: the
    tables' value widths (1-32).  Returns a list of [B, K] int32."""
    global table_launches
    tables = list(tables)
    masks = [_byte_mask(b) for b in bits]
    if not 1 <= len(tables) <= 4 or len(masks) != len(tables):
        raise ValueError("1-4 tables, one width each")
    _int32_on(idx.device, idx, *tables)
    B, N = tables[0].shape
    if idx.dim() != 2 or idx.shape[0] != B or N % LANE or N == 0 or any(
            t.shape != (B, N) for t in tables):
        raise ValueError("tables must be [B, N], N % 128 == 0, idx [B, K]")
    if idx.device.type == "cpu":
        return table_gather_reference(tables, idx, bits)
    if idx.numel() > 2**31 - 1 - 128:
        raise ValueError("the kernel takes at most 2**31 - 129 indices")
    tables = [t.contiguous() for t in tables]
    idx = idx.contiguous()
    outs = [torch.empty_like(idx) for _ in tables]
    pad = 4 - len(tables)
    _build.launch("lz4t_table_gather", idx.device,
                  *(t.data_ptr() for t in tables), *([None] * pad),
                  idx.data_ptr(), *(o.data_ptr() for o in outs),
                  *([None] * pad), *masks, *([0] * pad), len(tables), B, N,
                  idx.shape[1])
    table_launches += 1
    return outs


def table_gather_reference(tables, idx, bits):
    """Plain PyTorch version of ``table_gather``."""
    N = tables[0].shape[1]
    j = ((idx >> 7).clamp(0, N // LANE - 1) * LANE
         + (idx & (LANE - 1))).long()
    return [torch.gather(t, 1, j) & _byte_mask(b)
            for t, b in zip(tables, bits)]


def lane_lookup(tables, idx):
    """out[..., r, l] = tables[..., r, idx[..., r, l] & 127].

    tables/idx: int32 of one shape, last dim 128."""
    global lane_launches
    _int32_on(idx.device, idx, tables)
    if tables.shape != idx.shape or idx.dim() < 1 or idx.shape[-1] != LANE:
        raise ValueError("tables and idx must share a shape, last dim 128")
    if idx.device.type == "cpu":
        return lane_lookup_reference(tables, idx)
    tables, idx = tables.contiguous(), idx.contiguous()
    out = torch.empty_like(idx)
    if idx.numel():
        _build.launch("lz4t_lane_lookup", idx.device, tables.data_ptr(),
                      idx.data_ptr(), out.data_ptr(), idx.numel() // LANE)
        lane_launches += 1
    return out


def lane_lookup_reference(tables, idx):
    """Plain PyTorch version of ``lane_lookup``."""
    return torch.gather(tables.reshape(-1, LANE), 1,
                        (idx & (LANE - 1)).reshape(-1, LANE).long()) \
        .reshape(idx.shape)


def diag_gather(table, idx, back_rows: int, w_rows: int):
    """Gather table[b, idx[b, q]] where row idx >> 7 lies in the band
    [q // 128 - back_rows, q // 128 - back_rows + w_rows).

    table/idx: [B, N] int32, N % 128 == 0.  Returns (vals [B, N] int32,
    in_band [B, N] bool); vals is 0 out of band and where idx is outside
    [0, N), as the TPU kernel returns it."""
    global diag_launches
    _int32_on(idx.device, idx, table)
    if idx.dim() != 2 or table.shape != idx.shape or idx.shape[1] % LANE:
        raise ValueError("table and idx must be [B, N], N % 128 == 0")
    if not (0 <= back_rows < 1 << 24 and 0 <= w_rows < 1 << 24):
        raise ValueError("back_rows and w_rows must be in [0, 2**24)")
    if idx.device.type == "cpu":
        return diag_gather_reference(table, idx, back_rows, w_rows)
    table, idx = table.contiguous(), idx.contiguous()
    B, N = idx.shape
    vals = torch.empty_like(idx)
    in_band = torch.empty((B, N), dtype=torch.bool, device=idx.device)
    if idx.numel():
        _build.launch("lz4t_diag_gather", idx.device, table.data_ptr(),
                      idx.data_ptr(), vals.data_ptr(), in_band.data_ptr(),
                      B, N, back_rows, w_rows)
        diag_launches += 1
    return vals, in_band


def diag_gather_reference(table, idx, back_rows: int, w_rows: int):
    """Plain PyTorch version of ``diag_gather``."""
    N = idx.shape[1]
    q = torch.arange(N, dtype=torch.int32, device=idx.device)
    delta = (idx >> 7) - (q >> 7) + back_rows
    in_band = (delta >= 0) & (delta < w_rows)
    got = torch.gather(table, 1, idx.clamp(0, N - 1).long())
    vals = torch.where(in_band & (idx >= 0) & (idx < N), got, 0)
    return vals, in_band
