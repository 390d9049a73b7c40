"""Host engine: the pure-Python codec of models/portable/.

Copy of `libdeflate_rsx_tpu/engine.py` without its native tier. The JAX
package tries its C codec (native/codec.c) first and falls back to the
Python engine; the port has no native codec, so it always runs the
Python paths, which give the same bytes. Inputs over 256 KiB compress as
SYNC-joined chunks on the port's own host pool (hostpool.py), as the JAX
package's do on its pool. Level 0 uses the Python engine (stored
blocks) in both packages.
"""

from __future__ import annotations

from .common import WINDOW_SIZE as _WINDOW
from .models.portable.checksums import adler32_host, crc32_host
from .models.portable.deflate import Flush, deflate_host
from .models.portable.inflate import Inflater
from .utils.errors import (
    DecompressStatus,
    InsufficientSpaceError,
    ShortInputError,
)

# intra-buffer parallel chunking, the reference's >256 KiB scheme
# (reference src/compress/mod.rs:699-772) with history carried across
# chunk boundaries (see hostpool.py)
CHUNK_PARALLEL_SIZE = 256 * 1024


class Deflater:
    """Incremental raw-DEFLATE compressor across calls.

    `compress(data, flush)` returns the blocks for `data`; the 32 KiB LZ
    history persists between calls. The concatenation of everything
    returned is one valid DEFLATE stream. Without the native bit-phase
    engine, Flush.NONE joins byte-aligned like Flush.SYNC: the decoded
    bytes are the same, the stream marginally larger (as the JAX
    package's Deflater does while its native codec is absent)."""

    def __init__(self, level: int = 6) -> None:
        from .common import MAX_LEVEL, MIN_LEVEL
        from .utils.errors import LevelError
        if not (MIN_LEVEL <= level <= MAX_LEVEL):
            raise LevelError(f"compression level {level} outside 0..=12")
        self._level = level
        self._history = b""
        self._finished = False

    @property
    def pending_bits(self) -> int:
        """Valid bits of a retained partial byte: always 0 here."""
        return 0

    @property
    def finished(self) -> bool:
        return self._finished

    def compress(self, data, flush: Flush = Flush.NONE) -> bytes:
        if self._finished:
            raise ValueError("compress after FINISH")
        data = bytes(data)
        if flush == Flush.NONE and not data:
            return b""
        out = compress_raw(data, self._level,
                           Flush.FINISH if flush == Flush.FINISH
                           else Flush.SYNC, history=self._history)
        self._history = (self._history + data)[-_WINDOW:]
        if flush == Flush.FINISH:
            self._finished = True
        return out


def _compress_one_chunk(args) -> bytes:
    data, level, flush, history = args
    return deflate_host(data, level, flush, history=history)


def compress_raw(data: bytes, level: int, flush: Flush = Flush.FINISH,
                 history: bytes = b"") -> bytes:
    """Raw DEFLATE at any level; inputs over 256 KiB at levels 1-12
    compress as parallel SYNC-joined chunks on the host pool."""
    n = len(data)
    if 1 <= level <= 12 and n > CHUNK_PARALLEL_SIZE:
        from .hostpool import pmap, pool_width
        if pool_width() > 1:
            jobs = []
            pos = 0
            while pos < n:
                end = min(pos + CHUNK_PARALLEL_SIZE, n)
                hist = history if pos == 0 \
                    else data[max(0, pos - _WINDOW):pos]
                fl = flush if end == n else Flush.SYNC
                jobs.append((data[pos:end], level, fl, hist))
                pos = end
            return b"".join(pmap(_compress_one_chunk, jobs))
    return deflate_host(data, level, flush, history=history)


def decompress_raw(data: bytes, max_out: int):
    """One-shot raw DEFLATE decode -> (bytes, consumed)."""
    d = Inflater()
    out = bytearray()
    status, consumed = d.step(data, out, max_out)
    if status == DecompressStatus.SHORT_INPUT:
        raise ShortInputError("compressed data truncated")
    if status == DecompressStatus.INSUFFICIENT_SPACE:
        raise InsufficientSpaceError("decompressed data exceeds buffer")
    return bytes(out), consumed


def crc32(data: bytes, crc: int = 0) -> int:
    return crc32_host(data, crc)


def adler32(data: bytes, adler: int = 1) -> int:
    return adler32_host(data, adler)
