"""lz4net_tpu_torch: the PyTorch/CUDA port of lz4net_tpu.

LZ4 block decode (known-length, unknown-length and preset-dictionary),
strict, fast greedy and fast-HC block encode (with or without a preset
dictionary), the 8-byte wrap envelope and lz4net's LZ4Stream chunk
framing, on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``),
each with a plain PyTorch version beside it; ``registry`` selects the
engines.  ``encode`` and ``encode_hc`` default to the strict path: the
reference compressor's bytes.
The package imports torch and numpy, never JAX or ``lz4net_tpu``.  Entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from .codec import (codec_name, decode, decode_batch, encode, encode_hc,
                    unwrap, wrap, wrap_hc)
from .constants import maximum_output_length
from .models.reference import CorruptedBlockError
from .stream import LZ4Stream, LZ4StreamFlags, LZ4StreamMode

__all__ = ["codec_name", "decode", "decode_batch", "encode", "encode_hc",
           "maximum_output_length", "wrap", "wrap_hc", "unwrap",
           "LZ4Stream", "LZ4StreamFlags", "LZ4StreamMode",
           "CorruptedBlockError"]
