"""DEFLATE / zlib / gzip format constants (RFC 1951/1950/1952).

This is the TPU-native analog of the reference's format-constant module
(cf. reference src/common.rs:1-75): symbol counts, the 32 KiB LZ window,
length/offset code tables, and the block-splitting tunables. All values
here are dictated by the public RFCs; the tunables mirror the reference's
behavior (MIN_BLOCK_LENGTH / SOFT_MAX_BLOCK_LENGTH / SEQ_STORE_LENGTH).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# DEFLATE core constants (RFC 1951)
# ---------------------------------------------------------------------------

WINDOW_SIZE = 32768          # max LZ77 back-reference distance
MIN_MATCH_LEN = 3
MAX_MATCH_LEN = 258

NUM_LITLEN_SYMS = 288        # 0..255 literals, 256 EOB, 257..285 lengths (+2 reserved)
NUM_OFFSET_SYMS = 32         # 0..29 used (+2 reserved)
NUM_PRECODE_SYMS = 19
END_OF_BLOCK = 256

MAX_LITLEN_CODEWORD_LEN = 15   # format limit
MAX_OFFSET_CODEWORD_LEN = 15
MAX_PRE_CODEWORD_LEN = 7

# Encoder-side codeword-length limits (tighter than the format allows, which
# enables fused table-driven emission; mirrors reference src/compress/mod.rs:127-129)
ENC_MAX_LITLEN_LEN = 14
ENC_MAX_OFFSET_LEN = 15
ENC_MAX_PRE_LEN = 7

# Block types
BLOCKTYPE_STORED = 0
BLOCKTYPE_STATIC = 1
BLOCKTYPE_DYNAMIC = 2

MAX_STORED_BLOCK_LEN = 65535

# Block-splitting tunables (reference src/common.rs:68-69 and compressor use)
MIN_BLOCK_LENGTH = 5000
SOFT_MAX_BLOCK_LENGTH = 300000
SEQ_STORE_LENGTH = 50000

# Intra-buffer parallel chunking threshold/granule (reference
# src/compress/mod.rs:699-772 uses 256 KiB rayon chunks; we use the same
# granule as the per-device / per-grid-cell shard unit on TPU).
PARALLEL_CHUNK_SIZE = 256 * 1024

# ---------------------------------------------------------------------------
# Length code table: symbols 257..285 (RFC 1951 §3.2.5)
# LENGTH_SYM_BASE[i] / LENGTH_SYM_EXTRA[i] correspond to litlen symbol 257+i.
# ---------------------------------------------------------------------------

LENGTH_SYM_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
LENGTH_SYM_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)

# length (3..258) -> litlen symbol (257..285), precomputed dense table
_len_to_sym = np.zeros(MAX_MATCH_LEN + 1, dtype=np.int32)
for _i, (_base, _extra) in enumerate(zip(LENGTH_SYM_BASE, LENGTH_SYM_EXTRA)):
    _hi = _base + (1 << _extra) - 1
    _len_to_sym[_base:min(_hi, MAX_MATCH_LEN) + 1] = 257 + _i
_len_to_sym[MAX_MATCH_LEN] = 285  # length 258 is its own symbol, 0 extra bits
LENGTH_TO_SYMBOL = _len_to_sym

# ---------------------------------------------------------------------------
# Offset (distance) code table: symbols 0..29 (RFC 1951 §3.2.5)
# ---------------------------------------------------------------------------

OFFSET_SYM_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
     12289, 16385, 24577],
    dtype=np.int32,
)
OFFSET_SYM_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)


def offset_to_symbol_table() -> np.ndarray:
    """Dense offset(1..32768) -> offset symbol table (index 0 unused)."""
    t = np.zeros(WINDOW_SIZE + 1, dtype=np.int32)
    for i, (base, extra) in enumerate(zip(OFFSET_SYM_BASE, OFFSET_SYM_EXTRA)):
        hi = base + (1 << extra) - 1
        t[base:min(hi, WINDOW_SIZE) + 1] = i
    return t


OFFSET_TO_SYMBOL = offset_to_symbol_table()

# offset -> symbol via bit-length math (used by vectorized TPU paths to avoid
# a 32769-entry gather): for offset o, sym = 2*(bsr(o-1)) adjusted; we keep the
# dense table for host code and compute log2-based form in ops/.

# ---------------------------------------------------------------------------
# Precode (code-length code) constants (RFC 1951 §3.2.7)
# ---------------------------------------------------------------------------

PRECODE_PERMUTATION = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)
# precode symbols 16/17/18 extra bits and repeat ranges
PRECODE_REPEAT_EXTRA = {16: 2, 17: 3, 18: 7}
PRECODE_REPEAT_BASE = {16: 3, 17: 3, 18: 11}

# ---------------------------------------------------------------------------
# Static (fixed) Huffman code (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------


def static_litlen_lens() -> np.ndarray:
    lens = np.empty(NUM_LITLEN_SYMS, dtype=np.int32)
    lens[0:144] = 8
    lens[144:256] = 9
    lens[256:280] = 7
    lens[280:288] = 8
    return lens


def static_offset_lens() -> np.ndarray:
    return np.full(NUM_OFFSET_SYMS, 5, dtype=np.int32)


# ---------------------------------------------------------------------------
# Container framing constants
# ---------------------------------------------------------------------------

ZLIB_CM_DEFLATE = 8
ZLIB_CINFO_32K = 7
GZIP_MAGIC = b"\x1f\x8b"
GZIP_CM_DEFLATE = 8
GZIP_OS_UNKNOWN = 255

GZIP_FTEXT = 0x01
GZIP_FHCRC = 0x02
GZIP_FEXTRA = 0x04
GZIP_FNAME = 0x08
GZIP_FCOMMENT = 0x10
GZIP_RESERVED_FLAGS = 0xE0

# Checksum initial values
CRC32_INIT = 0
ADLER32_INIT = 1
ADLER32_MOD = 65521

# Compression levels
MIN_LEVEL = 0
MAX_LEVEL = 12
DEFAULT_LEVEL = 6

# Decompressor security defaults (reference src/api.rs:213-239)
DEFAULT_LIMIT_RATIO = 2000
DEFAULT_LIMIT_SLACK = 4096


def bsr32(x: int) -> int:
    """Index of highest set bit (x > 0)."""
    return x.bit_length() - 1


def deflate_compress_bound(n: int) -> int:
    """Worst-case DEFLATE output size for n input bytes.

    Stored blocks cost 5 bytes of header per 65535-byte chunk plus (for the
    final bit-aligned flush) a small constant. Mirrors the reference's bound
    formula (reference src/api.rs:59-69): n + (n/65535 + 1) * 5 + 10.
    """
    return n + (n // MAX_STORED_BLOCK_LEN + 1) * 5 + 10


def zlib_compress_bound(n: int) -> int:
    return deflate_compress_bound(n) + 2 + 4  # header + adler32


def gzip_compress_bound(n: int) -> int:
    return deflate_compress_bound(n) + 10 + 8  # header + crc32 + isize
