"""Block facade of the CUDA port (counterpart of ``lz4net_tpu/codec.py``:
``codec_name``, :19-21, strict and fast encode, :33-66, fast-HC and
strict HC encode, :69-101, decode of known, unknown and
preset-dictionary length, :104-132, batched decode, :135-157, and the
8-byte wrap envelope, :160-200), and ``encode_batch``, the write-side twin
of ``decode_batch`` that the stream's writes call (the JAX package's
stream encodes a chunk a call).  The strict paths and decode go through
the engines ``registry`` selected for the device; the fast modes run the
card's vector encoder directly, as the JAX package's run its TPU engine
directly.
Every call takes ``device=``: the card (``"cuda"``) unless the caller
asks for the CPU."""

from __future__ import annotations

import struct

from . import registry
from .constants import (HC_LEVEL_DEFAULT, WRAP_HEADER_LENGTH,
                        maximum_output_length)
from .models import cuda


def codec_name(device="cuda") -> str:
    """"encoder/decoder/encoderHC" triple of the engines ``registry``
    selected for ``device``, in the JAX package's format
    (``"cuda/cuda/cudaHC"`` by the static order)."""
    return registry.codec_name(device)


def _check_mode(mode: str) -> None:
    if mode not in ("strict", "fast"):
        raise ValueError(f"unknown mode {mode!r}")


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
    bound).  ``dictionary`` enables preset-dictionary matching (decode
    must supply the same bytes): fast mode runs the vector encoder's P
    mode on the card, strict mode the reference dictionary compressor on
    the native host engine, as the JAX package runs it on its host
    oracle.
    """
    _check_mode(mode)
    if len(src) == 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(src))
    if dictionary:
        if mode == "fast":
            return cuda.compress_blocks_fast_dict(
                [bytes(src)], dictionary, [dst_maxlen], device=device)[0]
        return cuda.compress_block_dict(dictionary, bytes(src), dst_maxlen,
                                        device)
    if mode == "strict":
        return registry.encoder(device).encode(bytes(src), dst_maxlen)
    return cuda.compress_blocks_fast([bytes(src)], [dst_maxlen], device)[0]


def encode_batch(blocks, dst_maxlens, device="cuda") -> list:
    """Batched strict encode of independent blocks: one device pass on the
    ``cuda`` engine (the stream's write path).  Each payload is what
    ``encode(block, cap)`` returns: b"" for an empty block, or for one
    whose payload would not fit its ``dst_maxlens`` entry."""
    blocks = [bytes(b) for b in blocks]
    dst_maxlens = list(dst_maxlens)
    nonempty = [i for i, b in enumerate(blocks) if b]
    results = [b""] * len(blocks)
    sub = registry.encoder(device).encode_batch(
        [blocks[i] for i in nonempty], [dst_maxlens[i] for i in nonempty])
    for i, r in zip(nonempty, sub):
        results[i] = r
    return results


def encode_hc(src: bytes, dst_maxlen: int | None = None,
              level: int = HC_LEVEL_DEFAULT, *,
              dictionary: bytes | None = None, mode: str = "strict",
              device="cuda") -> bytes:
    """LZ4HC block compression at ``level`` (1..9; 9 is the reference's
    fixed-effort parse).

    ``mode="strict"`` (the default) is the reference HC parse, run on the
    native host engine as the JAX package runs it on its C++ oracle.
    ``mode="fast"`` runs the fast-HC encoder on the card: format-valid
    output, byte-identical to the JAX package's fast-HC mode, not to the
    reference HC parse.  Returns b""
    when the result would not fit ``dst_maxlen`` (default: the
    worst-case bound).  ``dictionary`` as in ``encode``.
    """
    _check_mode(mode)
    if len(src) == 0:
        return b""
    if dst_maxlen is None:
        dst_maxlen = maximum_output_length(len(src))
    if dictionary:
        if mode == "fast":
            return cuda.compress_blocks_fast_dict(
                [bytes(src)], dictionary, [dst_maxlen], level=max(level, 1),
                device=device)[0]
        return cuda.compress_block_hc_dict(dictionary, bytes(src),
                                           dst_maxlen, level, device)
    if mode == "strict":
        return registry.encoder_hc(device).encode_hc(bytes(src), dst_maxlen,
                                                     level)
    return cuda.compress_blocks_hc_fast([bytes(src)], [dst_maxlen], level,
                                        device)[0]


def decode(src: bytes, output_length: int | None = None, *,
           max_output_length: int | None = None,
           dictionary: bytes | None = None, device="cuda") -> bytes:
    """Decompress one LZ4 block.

    ``output_length`` set: known-output-length decode (with
    ``dictionary``, the preset-dictionary decode, which needs it).
    Otherwise ``max_output_length`` must be given: the hardened
    unknown-length decode.
    """
    if dictionary:
        if output_length is None:
            raise ValueError("dictionary decode requires output_length")
        if output_length == 0:
            return b""
        return registry.decoder(device).decode_dict(bytes(src), dictionary,
                                                    output_length)
    if output_length is not None:
        if output_length == 0:
            return b""
        return registry.decoder(device).decode(bytes(src), output_length)
    if max_output_length is None:
        raise ValueError(
            "either output_length or max_output_length is required")
    if len(src) == 0:
        return b""
    return registry.decoder(device).decode_unknown(bytes(src),
                                                   max_output_length)


def decode_batch(blocks, output_lengths, device="cuda") -> list:
    """Batched known-length decode of independent blocks: one device pass
    on the ``cuda`` engine (the stream's read-ahead path); blocks of
    decoded length 0 decode to b"" without one."""
    blocks = [bytes(b) for b in blocks]
    output_lengths = list(output_lengths)
    nonzero = [i for i, n in enumerate(output_lengths) if n > 0]
    results = [b""] * len(blocks)
    sub = registry.decoder(device).decode_batch(
        [blocks[i] for i in nonzero], [output_lengths[i] for i in nonzero])
    for i, r in zip(nonzero, sub):
        results[i] = r
    return results


# ---------------------------------------------------------------------------
# Wrap envelope: [u32le originalLength][u32le payloadLength][payload], the
# payload stored raw when compression does not shrink it.
# ---------------------------------------------------------------------------

def _wrap(src: bytes, high_compression: bool, level: int, device) -> bytes:
    n = len(src)
    if n == 0:
        return bytes(WRAP_HEADER_LENGTH)
    # compressed into a buffer of only n bytes, so "did not fit" doubles
    # as the incompressible signal
    packed = (encode_hc(src, n, level, device=device) if high_compression
              else encode(src, n, device=device))
    if not packed or len(packed) >= n:
        return struct.pack("<II", n, n) + src
    return struct.pack("<II", n, len(packed)) + packed


def wrap(src: bytes, *, device="cuda") -> bytes:
    """Compress (strict mode) and wrap with the 8-byte envelope."""
    return _wrap(bytes(src), False, HC_LEVEL_DEFAULT, device)


def wrap_hc(src: bytes, level: int = HC_LEVEL_DEFAULT, *,
            device="cuda") -> bytes:
    """High-compression (strict HC) wrap."""
    return _wrap(bytes(src), True, level, device)


def unwrap(src: bytes, *, device="cuda") -> bytes:
    """Inverse of ``wrap`` and ``wrap_hc``."""
    src = bytes(src)
    if len(src) < WRAP_HEADER_LENGTH:
        raise ValueError("input buffer size is invalid")
    original_length, payload_length = struct.unpack_from("<II", src, 0)
    if payload_length > len(src) - WRAP_HEADER_LENGTH:
        raise ValueError("input buffer size is invalid or has been corrupted")
    payload = src[WRAP_HEADER_LENGTH:WRAP_HEADER_LENGTH + payload_length]
    if payload_length >= original_length:
        return payload
    return decode(payload, original_length, device=device)
