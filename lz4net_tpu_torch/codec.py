"""Block facade of the CUDA port (counterpart of ``lz4net_tpu/codec.py``:
strict and fast encode, :33-66, fast-HC encode, :69-101, and known-length
decode, :104-157)."""

from __future__ import annotations

from .constants import HC_LEVEL_DEFAULT, maximum_output_length
from .models import cuda
from .models.service_adapters import CudaService


def encode(src: bytes, dst_maxlen: int | None = None, *,
           dictionary: bytes | None = None, mode: str = "strict",
           device="cuda") -> bytes:
    """Greedy LZ4 block compression.

    ``mode="strict"`` (the default) runs the strict sequencer encoder on
    the card: the reference parse, byte-identical to the JAX package's
    ``encode`` and to the reference compressor.  ``mode="fast"`` runs the
    vector encoder on the card: format-valid output, byte-identical to the
    JAX package's fast mode, not to the reference parse.  Returns b"" when
    the result would not fit ``dst_maxlen`` (default: the worst-case
    bound).  ``dictionary`` is not ported yet.
    """
    if mode not in ("strict", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if dictionary:
        raise NotImplementedError(
            "preset-dictionary encode is not ported yet: ROADMAP.md queue "
            "A, item 7")
    if len(src) == 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(src))
    if mode == "strict":
        return CudaService(device).encode(bytes(src), dst_maxlen)
    return cuda.compress_blocks_fast([bytes(src)], [dst_maxlen], device)[0]


def encode_hc(src: bytes, dst_maxlen: int | None = None,
              level: int = HC_LEVEL_DEFAULT, *,
              dictionary: bytes | None = None, mode: str = "strict",
              device="cuda") -> bytes:
    """LZ4HC block compression at ``level`` (1..9).

    ``mode="fast"`` runs the fast-HC encoder on the card: format-valid
    output, byte-identical to the JAX package's fast-HC mode, not to the
    reference HC parse.  Returns b"" when the result would not fit
    ``dst_maxlen`` (default: the worst-case bound).  ``mode="strict"``
    (the reference HC parse) and ``dictionary`` are not ported yet.
    """
    if mode not in ("strict", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if dictionary:
        raise NotImplementedError(
            "preset-dictionary HC encode is not ported yet: ROADMAP.md "
            "queue A, item 7")
    if mode == "strict":
        raise NotImplementedError(
            "strict HC encode is not ported yet: ROADMAP.md queue A, item "
            "10; use mode='fast'")
    if len(src) == 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(src))
    return cuda.compress_blocks_hc_fast([bytes(src)], [dst_maxlen], level,
                                        device)[0]


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
