"""lz4net_tpu_torch: the PyTorch/CUDA port of lz4net_tpu.

Known-length LZ4 block decode, and strict, fast greedy and fast-HC block
encode, on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``),
each with a plain PyTorch version beside it.  ``encode`` defaults to the
strict path: the reference compressor's bytes.
The package imports torch and numpy, never JAX or ``lz4net_tpu``.  Entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from .codec import decode, decode_batch, encode, encode_hc
from .models.reference import CorruptedBlockError

__all__ = ["decode", "decode_batch", "encode", "encode_hc",
           "CorruptedBlockError"]
