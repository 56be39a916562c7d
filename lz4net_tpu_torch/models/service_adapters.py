"""Engine adapters of the CUDA port (counterparts of ``TpuService`` and
``PythonReferenceService`` in ``lz4net_tpu/models/service_adapters.py:
12-38, 92-128``).  ``NativeService`` has none: the JAX package's C++
host oracle is not ported (``models/reference.py`` holds the port's
host codecs)."""

from __future__ import annotations

from ..constants import HC_LEVEL_DEFAULT, MAX_NB_ATTEMPTS, hc_level_attempts
from . import cuda, reference


class PythonReferenceService:
    """Pure-Python engine over the port's ``models.reference``."""

    codec_name = "python-reference"

    def encode(self, src: bytes, dst_maxlen: int) -> bytes:
        return reference.compress_block(src, dst_maxlen)

    def encode_hc(self, src: bytes, dst_maxlen: int,
                  level: int = HC_LEVEL_DEFAULT) -> bytes:
        attempts = MAX_NB_ATTEMPTS if level >= 9 else hc_level_attempts(level)
        return reference.compress_block_hc(src, dst_maxlen, attempts)

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
        """Strict HC encode: the reference HC parse (on the host, as the
        JAX package's engine runs it)."""
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
