"""LZ4 block-format constants used by the PyTorch/CUDA port.

The port's own copy of the values it needs from the JAX package's
``lz4net_tpu/constants.py:10-78`` (the format is normatively described by
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

MAXD_LOG = 16
MAXD = 1 << MAXD_LOG             # HC chain table size
MAXD_MASK = MAXD - 1
MAX_DISTANCE = (1 << MAXD_LOG) - 1   # 65535: maximum (and window) match offset
# only the last 64 KB of a preset dictionary is reachable (offsets are
# 16-bit; the closest in-block destination is the block start)
MAX_DISTANCE_WINDOW = MAX_DISTANCE + 1

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

# --- high-compression (HC) tuning ------------------------------------------
HASHHC_LOG = MAXD_LOG - 1        # 15 -> 32768-entry head table
HASHHC_TABLESIZE = 1 << HASHHC_LOG
HASHHC_ADJUST = (MINMATCH * 8) - HASHHC_LOG      # 17

MAX_NB_ATTEMPTS = 256            # reference HC chain-walk budget (fixed effort)
OPTIMAL_ML = (ML_MASK - 1) + MINMATCH            # 18: lazy-parse trim target

# HC "levels 1..9" are an extension over the reference (which has a single
# fixed effort); level maps to a chain-walk attempt budget, with level 9
# equal to the reference's fixed MAX_NB_ATTEMPTS so ratio parity holds.
HC_LEVEL_DEFAULT = 9


def hc_level_attempts(level: int) -> int:
    """Map an HC compression level (1..9) to a chain-walk attempt budget
    (levels 8 and 9: the reference's fixed 256-attempt search)."""
    level = max(1, min(9, int(level)))
    return min(1 << level, MAX_NB_ATTEMPTS)  # 2,4,...,256,256


def maximum_output_length(input_length: int) -> int:
    """Worst-case compressed size for a block of ``input_length`` bytes."""
    return input_length + input_length // 255 + 16


# --- envelope --------------------------------------------------------------
WRAP_HEADER_LENGTH = 8           # u32le original length, u32le payload length

# --- LZ4Stream chunk framing (lz4net's own, not the official LZ4 frame) ----
CHUNK_COMPRESSED = 0x01
CHUNK_HIGH_COMPRESSION = 0x02
CHUNK_PASSES_MASK = 0x04 | 0x08 | 0x10   # reserved, only 0 supported

DEFAULT_BLOCK_SIZE = 1024 * 1024
MIN_BLOCK_SIZE = 16
