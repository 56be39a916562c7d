"""Engine adapters of the CUDA port: ``CudaService``, ``NativeService``
and ``PythonReferenceService``, the counterparts of ``TpuService``,
``NativeService`` and ``PythonReferenceService`` in
``lz4net_tpu/models/service_adapters.py:12-128``."""

from __future__ import annotations

import numpy as np

from ..constants import HC_LEVEL_DEFAULT, hc_level_attempts
from . import cuda, native, reference


class PythonReferenceService:
    """Pure-Python engine over the port's ``models.reference``."""

    codec_name = "python-reference"

    def encode(self, src: bytes, dst_maxlen: int) -> bytes:
        return reference.compress_block(src, dst_maxlen)

    def encode_hc(self, src: bytes, dst_maxlen: int,
                  level: int = HC_LEVEL_DEFAULT) -> bytes:
        return reference.compress_block_hc(src, dst_maxlen,
                                           hc_level_attempts(level))

    def decode(self, src: bytes, output_length: int) -> bytes:
        return reference.decompress_block(src, output_length)

    def decode_unknown(self, src: bytes, max_output_length: int) -> bytes:
        return reference.decompress_block_unknown(src, max_output_length)

    def decode_dict(self, src: bytes, dictionary: bytes,
                    output_length: int) -> bytes:
        return reference.decompress_block_dict(src, dictionary,
                                               output_length)

    def decode_batch(self, blocks, output_lengths):
        """A block at a time."""
        return [reference.decompress_block(b, n)
                for b, n in zip(blocks, output_lengths)]

    def encode_batch(self, blocks, dst_maxlens):
        """A block at a time."""
        return [self.encode(b, n) for b, n in zip(blocks, dst_maxlens)]


class NativeService:
    """The native host engine (``models.native``), the port's copy of the
    JAX package's C++ oracle and the analogue of the reference's
    mixed-mode native engine (LZ4mm + libLZ4).  Building it raises
    ``RuntimeError`` where the host compiler cannot."""

    codec_name = "native"

    def __init__(self):
        native.build()

    def encode(self, src: bytes, dst_maxlen: int) -> bytes:
        return native.compress_block(src, dst_maxlen)

    def encode_hc(self, src: bytes, dst_maxlen: int,
                  level: int = HC_LEVEL_DEFAULT) -> bytes:
        return native.compress_block_hc(src, dst_maxlen,
                                        hc_level_attempts(level))

    def decode(self, src: bytes, output_length: int) -> bytes:
        return native.decompress_block(src, output_length)

    def decode_unknown(self, src: bytes, max_output_length: int) -> bytes:
        return native.decompress_block_unknown(src, max_output_length)

    def decode_dict(self, src: bytes, dictionary: bytes,
                    output_length: int) -> bytes:
        return native.decompress_block_dict(src, dictionary, output_length)

    def decode_batch(self, blocks, output_lengths):
        """Batched known-length decode over the pthread C++ path."""
        blocks = [bytes(b) for b in blocks]
        if not blocks:
            return []
        lengths = [len(b) for b in blocks]
        offsets = np.cumsum([0] + lengths[:-1])
        out_lengths = list(output_lengths)
        concat, _read = native.decompress_blocks(
            b"".join(blocks), offsets, lengths, out_lengths)
        ends = np.cumsum([0] + out_lengths)
        return [concat[a:b] for a, b in zip(ends[:-1], ends[1:])]

    def encode_batch(self, blocks, dst_maxlens):
        """A block at a time."""
        return [self.encode(b, n) for b, n in zip(blocks, dst_maxlens)]


class CudaService:
    """Batched CUDA engine over independent blocks."""

    codec_name = "cuda"

    def __init__(self, device="cuda"):
        self.device = device
        cuda.decoder(device)     # raises for CUDA without a card

    def encode(self, src: bytes, dst_maxlen: int) -> bytes:
        """Strict encode: the reference compressor's bytes, on the card."""
        return cuda.compress_block(src, dst_maxlen, self.device)

    def encode_hc(self, src: bytes, dst_maxlen: int,
                  level: int = HC_LEVEL_DEFAULT) -> bytes:
        """Strict HC encode: the reference HC parse (on the native host
        engine, as the JAX package's engine runs it)."""
        return cuda.compress_block_hc(src, dst_maxlen, level, self.device)

    def decode(self, src: bytes, output_length: int) -> bytes:
        return cuda.decompress_block(src, output_length, self.device)

    def decode_unknown(self, src: bytes, max_output_length: int) -> bytes:
        return cuda.decompress_block_unknown(src, max_output_length,
                                             self.device)

    def decode_dict(self, src: bytes, dictionary: bytes,
                    output_length: int) -> bytes:
        return cuda.decompress_block_dict(src, dictionary, output_length,
                                          self.device)

    def decode_batch(self, blocks, output_lengths):
        """One device pass for the whole batch."""
        return cuda.decompress_blocks(list(blocks), list(output_lengths),
                                      self.device)

    def encode_batch(self, blocks, dst_maxlens):
        """Strict encode, one launch for the whole batch."""
        return cuda.compress_blocks(list(blocks), list(dst_maxlens),
                                    self.device)
