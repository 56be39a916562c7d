"""Engine adapter for the CUDA port (counterpart of ``TpuService`` in
``lz4net_tpu/models/service_adapters.py:92-128``): known-length decode
only, the part of the service this port slice carries."""

from __future__ import annotations

from . import cuda


class CudaService:
    """Batched CUDA decode engine over independent blocks."""

    codec_name = "cuda"

    def __init__(self, device="cuda"):
        self.device = device
        cuda.decoder(device)     # raises for CUDA without a card

    def decode(self, src: bytes, output_length: int) -> bytes:
        return cuda.decompress_block(src, output_length, self.device)

    def decode_batch(self, blocks, output_lengths):
        """One device pass for the whole batch."""
        return cuda.decompress_blocks(list(blocks), list(output_lengths),
                                      self.device)
