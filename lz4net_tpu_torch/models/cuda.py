"""The CUDA engine: known-length block decode, and fast greedy and
fast-HC block encode on the card.

Port of the decode entry points of ``lz4net_tpu/models/tpu.py``
(:127-154), of its ``compress_blocks_fast`` (:83-92) and of its
``compress_blocks_hc_fast`` (:117-124).  The JAX package
makes a decoder or encoder per call; here one ``VectorDecoder`` and one
``VectorEncoder`` per device are kept, so their ``host_decodes`` and
``host_encodes`` counts can be read after a run.
"""

from __future__ import annotations

import torch

from ..ops.decode_vector import VectorDecoder, resolve_device
from ..ops.encode_vector import VectorEncoder

_DECODERS: dict[torch.device, VectorDecoder] = {}
_ENCODERS: dict[torch.device, VectorEncoder] = {}


def is_available() -> bool:
    return torch.cuda.is_available()


def decoder(device="cuda") -> VectorDecoder:
    """The decoder serving ``device`` (raises for CUDA without a card)."""
    device = resolve_device(device)
    if device not in _DECODERS:
        _DECODERS[device] = VectorDecoder(device)
    return _DECODERS[device]


def decompress_block(src: bytes, output_length: int,
                     device="cuda") -> bytes:
    return decoder(device).decode_batch([bytes(src)], [output_length])[0]


def decompress_blocks(blocks, out_lens, device="cuda"):
    """Batched known-length decode, one device pass for the batch."""
    return decoder(device).decode_batch(list(blocks), list(out_lens))


def encoder(device="cuda") -> VectorEncoder:
    """The fast and fast-HC encoder serving ``device`` (raises for CUDA without a
    card)."""
    device = resolve_device(device)
    if device not in _ENCODERS:
        _ENCODERS[device] = VectorEncoder(device)
    return _ENCODERS[device]


def compress_blocks_fast(blocks, dst_maxlens=None, device="cuda"):
    """Batched fast greedy encode, one device pass for the batch.

    The payloads are format-valid LZ4 blocks that every decoder reads,
    byte-identical to the JAX vector encoder's, not the reference
    compressor's parse.  A payload longer than its ``dst_maxlens`` entry
    comes back as b"".
    """
    return encoder(device).encode_batch(list(blocks), dst_maxlens)


def compress_blocks_hc_fast(blocks, dst_maxlens=None, level: int = 9,
                            device="cuda"):
    """Batched fast-HC encode, one device pass for the batch: deeper
    candidate tiers and, from level 4, the lazy parse (levels below 1
    run as 1, above 9 as 9).

    The payloads are format-valid LZ4 blocks, byte-identical to the JAX
    vector encoder's at the same level, not the reference HC parse.  A
    payload longer than its ``dst_maxlens`` entry comes back as b"".
    """
    return encoder(device).encode_batch(list(blocks), dst_maxlens,
                                        hc_level=max(1, level))
