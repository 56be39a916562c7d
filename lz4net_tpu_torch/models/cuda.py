"""The CUDA decode engine: known-length block decode on the card.

Port of the decode entry points of ``lz4net_tpu/models/tpu.py``
(:127-154).  The JAX package picks a decoder per call; here one
``VectorDecoder`` per device is kept, so its ``host_decodes`` count can
be read after a run.
"""

from __future__ import annotations

import torch

from ..ops.decode_vector import VectorDecoder, resolve_device

_DECODERS: dict[torch.device, VectorDecoder] = {}


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
