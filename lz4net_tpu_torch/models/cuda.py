"""The CUDA engine: known-length block decode, and strict, fast greedy and
fast-HC block encode on the card.

Port of the entry points of ``lz4net_tpu/models/tpu.py``: strict encode
(``compress_block``, ``compress_blocks``, :66-80), ``compress_blocks_fast``
(:83-92), ``compress_blocks_hc_fast`` (:117-124) and known-length decode
(:127-154).  The JAX package makes a decoder or encoder per call; here
one vector decoder and one vector encoder per device are kept, so their
``host_decodes`` and ``host_encodes`` counts can be read after a run.
Decode runs the vector decoder, as on the TPU; the sequencer decoder
(``ops.decode_sequencer.SequencerDecoder``, which the JAX package picks
off the TPU or by ``LZ4NET_TPU_DECODER``) is called directly by what
needs its status check.
"""

from __future__ import annotations

import torch

from ..ops.decode_vector import VectorDecoder, resolve_device
from ..ops.encode_sequencer import SequencerEncoder
from ..ops.encode_sequencer import compress_block  # noqa: F401 (one block)
from ..ops.encode_vector import VectorEncoder

_DECODERS: dict[torch.device, VectorDecoder] = {}
_ENCODERS: dict[torch.device, VectorEncoder] = {}


def is_available() -> bool:
    return torch.cuda.is_available()


def _kept(cache, cls, device):
    device = resolve_device(device)     # raises for CUDA without a card
    if device not in cache:
        cache[device] = cls(device)
    return cache[device]


def decoder(device="cuda") -> VectorDecoder:
    """The vector decoder serving ``device``."""
    return _kept(_DECODERS, VectorDecoder, device)


def decompress_block(src: bytes, output_length: int, device="cuda") -> bytes:
    return decoder(device).decode_batch([bytes(src)], [output_length])[0]


def decompress_blocks(blocks, out_lens, device="cuda"):
    """Batched known-length decode, one device pass for the batch."""
    return decoder(device).decode_batch(list(blocks), list(out_lens))


def encoder(device="cuda") -> VectorEncoder:
    """The fast and fast-HC encoder serving ``device``."""
    return _kept(_ENCODERS, VectorEncoder, device)


def compress_blocks(blocks, dst_maxlens=None, device="cuda"):
    """Batched strict encode, one launch for the batch: each payload is
    the reference compressor's bytes, or b"" when longer than its
    ``dst_maxlens`` entry.  Every block size runs on the card (the JAX
    package sends blocks over 48 KB to its host oracle); one block:
    ``compress_block``."""
    return SequencerEncoder(device).encode_batch(list(blocks), dst_maxlens)


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
