"""Wavefront match resolution: per-byte state words -> output bytes.

Port of the TPU kernel ``lz4net_tpu/ops/resolve_kernel.py:
resolve_wavefront``.  The CUDA kernel is ``csrc/resolve_kernel.cu`` (its
header says what bounds it on the H100 and what the design does about
that); ``resolve_wavefront_reference`` is its plain PyTorch version.

State words: ``t0[o] = VFLAG | byte`` for a terminal, else the position
of o's match source, which precedes o.  The output resolves in 8 KB
chunks, in order: inside a chunk by pointer doubling over the chunk-local
ordinals, across chunks by reading the bytes already resolved (the
kernel collapses every chunk in parallel and takes only this last step
in chunk order).  Chunks below ``start_chunk`` hold a pre-resolved
dictionary prefix and pass through.  ``ok`` is False only for a block
whose in-chunk pointers did not converge, which state words from
``records_to_state`` never cause.
"""

from __future__ import annotations

import torch

from .. import _build

CH = 8192            # chunk (output positions), as decode_vector.CH
VFLAG = 1 << 19
MAX_ROUNDS = 14      # 13 doublings reach 2^13 = CH; one more sees no change

launches = 0


def scratch_words(B: int, Dt: int) -> int:
    """int32 words of the kernel's scratch: its chunk counter and one
    ready flag a (block, chunk)."""
    return 1 + B * (Dt // CH)


def resolve_wavefront(t0, start_chunk: int = 0):
    """t0: [B, Dt] int32 (Dt % 8192 == 0).  Returns (out [B, Dt] int32
    bytes, ok [B] bool)."""
    global launches
    if t0.dtype != torch.int32 or t0.dim() != 2 or t0.shape[1] % CH:
        raise ValueError(f"t0 must be [B, Dt] int32 with Dt % {CH} == 0")
    if t0.device.type == "cpu":
        return resolve_wavefront_reference(t0, start_chunk)
    if t0.device.type != "cuda":
        raise ValueError(f"unsupported device {t0.device}")
    t0 = t0.contiguous()
    if t0.data_ptr() % 16:                # the kernel reads int4s
        t0 = t0.clone()
    B, Dt = t0.shape
    out = torch.empty_like(t0)
    ok = torch.empty(B, dtype=torch.bool, device=t0.device)
    scratch = torch.empty(scratch_words(B, Dt), dtype=torch.int32,
                          device=t0.device)
    _build.launch("lz4t_resolve_wavefront", t0.device, t0.data_ptr(),
                  out.data_ptr(), ok.data_ptr(), scratch.data_ptr(), B, Dt,
                  start_chunk)
    launches += 1
    return out, ok


def resolve_wavefront_reference(t0, start_chunk: int = 0):
    """Plain PyTorch version of ``resolve_wavefront`` (same outputs)."""
    B, Dt = t0.shape
    out = torch.zeros_like(t0)
    ok = torch.ones(B, dtype=torch.bool, device=t0.device)
    k = torch.arange(CH, dtype=torch.int32, device=t0.device).expand(B, CH)
    for j in range(Dt // CH):
        lo = j * CH
        t = t0[:, lo:lo + CH]
        if j < start_chunk:
            out[:, lo:lo + CH] = t & 0xFF
            continue
        n = torch.where((t < VFLAG) & (t >= lo),
                        (t - lo).clamp(max=CH - 1), k).long()
        changed = torch.ones(B, dtype=torch.bool, device=t0.device)
        for _ in range(MAX_ROUNDS):
            n2 = torch.gather(n, 1, n)
            changed = (n2 != n).any(1)
            n = n2
            if not bool(changed.any()):
                break
        ok &= ~changed
        tt = torch.gather(t, 1, n)
        if lo:
            cv = torch.gather(out[:, :lo], 1, tt.clamp(0, lo - 1).long())
        else:
            cv = torch.zeros_like(tt)
        out[:, lo:lo + CH] = torch.where(tt >= VFLAG, tt - VFLAG, cv) & 0xFF
    return out, ok
