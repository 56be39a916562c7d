"""Engine adapter for the CUDA port (counterpart of ``TpuService`` in
``lz4net_tpu/models/service_adapters.py:92-128``)."""

from __future__ import annotations

from ..constants import HC_LEVEL_DEFAULT
from . import cuda


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
