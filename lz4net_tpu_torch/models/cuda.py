"""The CUDA engine: known-length, unknown-length and preset-dictionary
block decode, and strict, fast greedy and fast-HC block encode, with or
without a preset dictionary, on the card.

Port of the entry points of ``lz4net_tpu/models/tpu.py``: strict encode
(``compress_block``, ``compress_blocks``, :66-80), ``compress_blocks_fast``
(:83-92), ``compress_blocks_fast_dict`` (:95-103), strict HC
(``compress_block_hc``, :106-114), ``compress_blocks_hc_fast``
(:117-124) and decode (:127-195), with strict dictionary encode
(``compress_block_dict``, ``compress_block_hc_dict``; the JAX facade's
``_dict_engine``).  Strict HC and strict dictionary encode run on the
native host engine (``models.native``), as the JAX package runs them on
its host oracle (``_oracle()``): no device kernel of either package
computes those parses.  The JAX
package makes a decoder or encoder per call; here one vector decoder,
one vector encoder and one strict encoder per device are kept
(``ops.host_rows.kept``), so the counts ``host_decodes`` and
``host_encodes`` can be read after a run, and their rows' buffers last
across calls.
Decode runs the vector decoder, as on the TPU; the sequencer decoder
(``ops.decode_sequencer.SequencerDecoder``, which the JAX package picks
off the TPU or by ``LZ4NET_TPU_DECODER``) is called directly by what
needs its status check.  Every entry point takes blocks of any size:
decode runs a block over 96 KB as waves of fragments of at most 96 KB
(one device pass a wave for the batch), fast and fast-HC encode as 64 KB
segments (one device pass for the segments of the batch).
"""

from __future__ import annotations

import torch

from ..constants import hc_level_attempts
from ..ops.decode_vector import VectorDecoder
from ..ops.encode_sequencer import SequencerEncoder
from ..ops.encode_sequencer import compress_block  # noqa: F401 (one block)
from ..ops.encode_vector import VectorEncoder
from ..ops.host_rows import kept, resolve_device
from . import native


def is_available() -> bool:
    return torch.cuda.is_available()


def decoder(device="cuda") -> VectorDecoder:
    """The vector decoder serving ``device``."""
    return kept(VectorDecoder, device)


def decompress_block(src: bytes, output_length: int, device="cuda") -> bytes:
    return decoder(device).decode_batch([bytes(src)], [output_length])[0]


def decompress_blocks(blocks, out_lens, device="cuda"):
    """Batched known-length decode, one device pass for the blocks of
    at most 96 KB and one a fragment wave for the bigger ones."""
    return decoder(device).decode_batch(list(blocks), list(out_lens))


def decompress_block_unknown(src: bytes, max_output_length: int,
                             device="cuda") -> bytes:
    """Unknown-output-length decode of one block on the card: the device
    certifies the hardened decoder's invariants, and a block it cannot
    certify is re-decoded by the host's hardened decoder, which raises
    the reference's errors for malformed input."""
    return decoder(device).decode_batch_unknown([bytes(src)],
                                                [max_output_length])[0]


def decompress_block_dict(src: bytes, dictionary: bytes, output_length: int,
                          device="cuda") -> bytes:
    """Known-length decode of one block with a preset dictionary, on the
    card: the window rides a prefix of the output domain."""
    return decoder(device).decode_batch([bytes(src)], [output_length],
                                        dictionary=dictionary)[0]


def decompress_blocks_dict(blocks, out_lens, dictionary: bytes,
                           device="cuda"):
    """Batched preset-dictionary decode, one device pass for the batch
    (one shared dictionary)."""
    return decoder(device).decode_batch(list(blocks), list(out_lens),
                                        dictionary=dictionary)


def encoder(device="cuda") -> VectorEncoder:
    """The fast and fast-HC encoder serving ``device``."""
    return kept(VectorEncoder, device)


def compress_blocks(blocks, dst_maxlens=None, device="cuda"):
    """Batched strict encode, one launch for the batch: each payload is
    the reference compressor's bytes, or b"" when longer than its
    ``dst_maxlens`` entry.  Every block size runs on the card (the JAX
    package sends blocks over 48 KB to its host oracle); one block:
    ``compress_block``."""
    return kept(SequencerEncoder, device).encode_batch(list(blocks),
                                                       dst_maxlens)


def compress_blocks_fast(blocks, dst_maxlens=None, device="cuda"):
    """Batched fast greedy encode, one device pass for the blocks of at
    most 96 KB and one for the 64 KB segments of the bigger ones.

    The payloads are format-valid LZ4 blocks that every decoder reads,
    byte-identical to the JAX vector encoder's, not the reference
    compressor's parse.  A payload longer than its ``dst_maxlens`` entry
    comes back as b"".
    """
    return encoder(device).encode_batch(list(blocks), dst_maxlens)


def compress_blocks_fast_dict(blocks, dictionary, dst_maxlens=None,
                              level: int = 0, device="cuda"):
    """Batched fast (``level`` 0) or fast-HC (1-9) encode against a preset
    dictionary, one device pass for the batch: the dictionary's last
    64 KB precede every block, and matches reach into it.  The payloads
    are byte-identical to the JAX vector encoder's in the same mode and
    decode with the same dictionary."""
    return encoder(device).encode_batch(list(blocks), dst_maxlens,
                                        hc_level=level,
                                        dictionary=dictionary)


def compress_block_hc(src: bytes, dst_maxlen: int | None = None,
                      level: int = 9, device="cuda") -> bytes:
    """Strict HC encode: the reference HC parse (level 9 the reference's
    256-attempt chain walk, lower levels fewer attempts), b"" when longer
    than ``dst_maxlen``.  It runs on the native host engine, as the JAX
    package's strict HC runs on its host oracle; the device's HC is
    ``compress_blocks_hc_fast``.  ``device`` is checked as every entry
    point checks it."""
    resolve_device(device)
    return native.compress_block_hc(bytes(src), dst_maxlen,
                                    hc_level_attempts(level))


def compress_block_dict(dictionary: bytes, src: bytes,
                        dst_maxlen: int | None = None,
                        device="cuda") -> bytes:
    """Strict encode against a preset dictionary: the reference
    dictionary compressor's bytes, b"" when longer than ``dst_maxlen``.
    It runs on the native host engine, as the JAX package runs it on its
    host oracle (no device kernel of either package computes this
    parse); the device's dictionary encode is
    ``compress_blocks_fast_dict``."""
    resolve_device(device)
    return native.compress_block_dict(dictionary, bytes(src), dst_maxlen)


def compress_block_hc_dict(dictionary: bytes, src: bytes,
                           dst_maxlen: int | None = None, level: int = 9,
                           device="cuda") -> bytes:
    """Strict HC encode against a preset dictionary: the reference HC
    parse with the window in front, on the host as
    ``compress_block_hc``; the device's is ``compress_blocks_fast_dict``
    at ``level`` 1-9."""
    resolve_device(device)
    return native.compress_block_hc_dict(dictionary, bytes(src), dst_maxlen,
                                         hc_level_attempts(level))


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
