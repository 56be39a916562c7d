"""Block-decode facade of the CUDA port (counterpart of
``lz4net_tpu/codec.py:104-157``, known-length decode only)."""

from __future__ import annotations

from .models.service_adapters import CudaService


def decode(src: bytes, output_length: int, device="cuda") -> bytes:
    """Decompress one LZ4 block of known decoded length."""
    if output_length == 0:
        return b""
    return CudaService(device).decode(bytes(src), output_length)


def decode_batch(blocks, output_lengths, device="cuda") -> list:
    """Batched known-length decode of independent blocks in one device
    pass; blocks of decoded length 0 decode to b"" without a pass."""
    blocks = [bytes(b) for b in blocks]
    output_lengths = list(output_lengths)
    svc = CudaService(device)
    nonzero = [i for i, n in enumerate(output_lengths) if n > 0]
    results = [b""] * len(blocks)
    sub = svc.decode_batch([blocks[i] for i in nonzero],
                           [output_lengths[i] for i in nonzero])
    for i, r in zip(nonzero, sub):
        results[i] = r
    return results
