"""LZ4 block-format constants used by the PyTorch/CUDA port.

The port's own copy of the values it needs from the JAX package's
``lz4net_tpu/constants.py:10-40`` (the format is normatively described by
the LZ4 block format description; the fast-compressor tuning mirrors the
r88/r93 reference so ``models.reference.compress_block`` stays
bit-identical to the reference parse).
"""

# --- core format ------------------------------------------------------------
MINMATCH = 4                     # minimum match length (token low nibble 0)
COPYLENGTH = 8                   # decoder wild-copy granularity
LASTLITERALS = 5                 # last 5 bytes of a block are always literals
MFLIMIT = COPYLENGTH + MINMATCH  # last match starts >= 12 bytes before end
MINLENGTH = MFLIMIT + 1          # blocks < 13 bytes are stored as literals

ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1     # 15: match-length nibble saturation
RUN_BITS = 8 - ML_BITS
RUN_MASK = (1 << RUN_BITS) - 1   # 15: literal-run nibble saturation

MAX_DISTANCE = (1 << 16) - 1     # 65535: maximum (and window) match offset

# --- fast (greedy) compressor tuning ---------------------------------------
SKIPSTRENGTH = 6                 # incompressible-skip acceleration exponent

HASH_LOG = 12                    # 4096-entry table (general blocks)
HASH_TABLESIZE = 1 << HASH_LOG
HASH_ADJUST = (MINMATCH * 8) - HASH_LOG          # 20

HASH64K_LOG = HASH_LOG + 1       # 8192-entry table (< 64 KB blocks)
HASH64K_TABLESIZE = 1 << HASH64K_LOG
HASH64K_ADJUST = (MINMATCH * 8) - HASH64K_LOG    # 19

LZ4_64KLIMIT = (1 << 16) + (MFLIMIT - 1)  # 65547: smaller inputs: 64K path

HASH_MULTIPLIER = 2654435761     # Knuth multiplicative hash constant


def maximum_output_length(input_length: int) -> int:
    """Worst-case compressed size for a block of ``input_length`` bytes."""
    return input_length + input_length // 255 + 16
