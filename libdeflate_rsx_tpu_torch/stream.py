"""Streaming DEFLATE encoder/decoder (reference src/stream.rs parity).

`DeflateEncoder` wraps a writable file-like object: writes are buffered
(default 1 MiB), and each flush splits the buffer into 256 KiB chunks
that are independently compressed and joined with SYNC flushes — the
reference's parallel chunk scheme (reference src/stream.rs:100-146).
Each chunk sees the previous chunk's last 32 KiB as LZ history, so the
chunks stay independently compressible (batch/device offload friendly)
without losing cross-chunk matches entirely.

`DeflateDecoder` wraps a readable file-like object and drives the
resumable `Inflater` state machine with a growing input buffer (32 KiB →
1 MiB) and a sliding output window keeping 32 KiB of history
(reference src/stream.rs:235-377).

Copy of `libdeflate_rsx_tpu/stream.py` without its native tier: the
decoders always drive the Python `Inflater` (the JAX package's C
decoder and its whole-stream fast path are absent here), and the
encoder's chunks run on the port's own host pool.
"""

from __future__ import annotations

from .common import WINDOW_SIZE
from .engine import compress_raw
from .models.portable.deflate import Flush
from .models.portable.inflate import Inflater
from .utils.errors import DecompressStatus, ShortInputError

DEFAULT_BUFFER_SIZE = 1 << 20
CHUNK_SIZE = 256 * 1024
_IN_START = 32 * 1024
_IN_MAX = 1 << 20
_OUT_CHUNK = 64 * 1024


class DeflateEncoder:
    """Buffered streaming raw-DEFLATE encoder over a writable object."""

    def __init__(self, writer, level: int = 6,
                 buffer_size: int = DEFAULT_BUFFER_SIZE) -> None:
        self._writer = writer
        self._level = level
        self._buffer_size = max(1, buffer_size)
        self._buf = bytearray()
        self._history = b""
        self._finished = False

    # -- io.Write parity -----------------------------------------------------

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("write after finish()")
        self._buf += bytes(data)
        if len(self._buf) >= self._buffer_size:
            self._flush_buffer(final=False)
        return len(data)

    def flush(self) -> None:
        """Compress and push everything buffered, ending byte-aligned
        (SYNC), then flush the inner writer."""
        if self._finished:
            return
        self._flush_buffer(final=False)
        if hasattr(self._writer, "flush"):
            self._writer.flush()

    def finish(self):
        """Emit the final block and return the inner writer."""
        if not self._finished:
            self._flush_buffer(final=True)
            self._finished = True
        return self._writer

    def close(self) -> None:
        """Best-effort finish (the reference's Drop impl,
        reference src/stream.rs:227-233)."""
        try:
            self.finish()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.finish()
        else:
            self.close()
        return False

    # -- internals ------------------------------------------------------------

    def _flush_buffer(self, final: bool) -> None:
        data = bytes(self._buf)
        self._buf.clear()
        if not data:
            out = compress_raw(b"", self._level,
                               Flush.FINISH if final else Flush.SYNC,
                               history=self._history)
            self._writer.write(out)
            return
        # parallel chunk compression (the reference's rayon flush,
        # reference src/stream.rs:100-146): each chunk's history is the
        # previous chunk's plaintext tail, known before compressing, so
        # chunks run concurrently on the host pool
        from .hostpool import pmap
        jobs = []
        pos = 0
        while pos < len(data):
            end = min(pos + CHUNK_SIZE, len(data))
            hist = self._history if pos == 0 \
                else data[max(0, pos - WINDOW_SIZE):pos]
            fl = Flush.FINISH if (final and end == len(data)) else Flush.SYNC
            jobs.append((data[pos:end], fl, hist))
            pos = end
        outs = pmap(self._compress_chunk, jobs)
        for out in outs:
            self._writer.write(out)
        self._history = (self._history + data)[-WINDOW_SIZE:]

    def _compress_chunk(self, job) -> bytes:
        chunk, fl, hist = job
        return compress_raw(chunk, self._level, fl, history=hist)


class GzipEncoder:
    """Streaming gzip encoder: DeflateEncoder with container framing and
    a running CRC-32 (BASELINE config #4: multi-member gzip streaming
    with dictionary carry-over across chunks — the inner encoder already
    carries each chunk's 32 KiB plaintext history across flushes).

    `new_member()` closes the current gzip member and starts another in
    the same output stream (concatenated members are a single valid gzip
    stream per RFC 1952 §2.2; `gunzip` and GzipDecoder decode them all).
    """

    def __init__(self, writer, level: int = 6,
                 buffer_size: int = DEFAULT_BUFFER_SIZE) -> None:
        self._writer = writer
        self._level = level
        self._buffer_size = buffer_size
        self._enc = DeflateEncoder(writer, level, buffer_size)
        self._crc = 0
        self._size = 0
        self._wrote_header = False
        self._finished = False

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("write after finish()")
        data = bytes(data)
        if not self._wrote_header:
            from . import containers
            self._writer.write(containers.gzip_header(self._level))
            self._wrote_header = True
        from .engine import crc32
        self._crc = crc32(data, self._crc)
        self._size += len(data)
        return self._enc.write(data)

    def flush(self) -> None:
        if not self._wrote_header and not self._finished:
            from . import containers
            self._writer.write(containers.gzip_header(self._level))
            self._wrote_header = True
        self._enc.flush()

    def _close_member(self) -> None:
        from . import containers
        if not self._wrote_header:
            self._writer.write(containers.gzip_header(self._level))
            self._wrote_header = True
        self._enc.finish()
        self._writer.write(containers.gzip_footer(self._crc, self._size))

    def new_member(self) -> None:
        """Finish the current gzip member and start a fresh one (own
        header/CRC/ISIZE, reset LZ history)."""
        if self._finished:
            raise ValueError("new_member after finish()")
        self._close_member()
        self._enc = DeflateEncoder(self._writer, self._level,
                                   self._buffer_size)
        self._crc = 0
        self._size = 0
        self._wrote_header = False

    def finish(self):
        if not self._finished:
            self._close_member()
            self._finished = True
        return self._writer

    def close(self) -> None:
        try:
            self.finish()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.finish()
        else:
            self.close()
        return False


class DeflateDecoder:
    """Streaming raw-DEFLATE decoder over a readable object."""

    def __init__(self, reader) -> None:
        self._reader = reader
        self._inflater = Inflater()
        self._in = bytearray()
        self._in_cap = _IN_START
        self._window = bytearray()      # history + undrained output
        self._drained = 0
        self._eof_in = False

    @property
    def finished(self) -> bool:
        return self._done() and self._available() == 0

    def _done(self) -> bool:
        return self._inflater.finished

    def _available(self) -> int:
        return len(self._window) - self._drained

    def _slide(self) -> None:
        if self._drained > WINDOW_SIZE and len(self._window) > 2 * WINDOW_SIZE:
            cut = self._drained - WINDOW_SIZE
            del self._window[:cut]
            self._drained -= cut

    def _refill(self) -> bool:
        """Read more compressed bytes; True if any arrived."""
        if self._eof_in:
            return False
        if len(self._in) >= self._in_cap and self._in_cap < _IN_MAX:
            self._in_cap = min(self._in_cap * 2, _IN_MAX)
        want = max(self._in_cap - len(self._in), 1)
        got = self._reader.read(want)
        if not got:
            self._eof_in = True
            return False
        self._in += got
        return True

    def read(self, size: int = -1) -> bytes:
        out = bytearray()
        while size < 0 or len(out) < size:
            avail = self._available()
            if avail:
                take = avail if size < 0 else min(avail, size - len(out))
                out += self._window[self._drained: self._drained + take]
                self._drained += take
                self._slide()
                continue
            if self._done():
                break
            status, consumed = self._inflater.step(
                bytes(self._in), self._window,
                len(self._window) + _OUT_CHUNK)
            del self._in[:consumed]
            if status == DecompressStatus.SHORT_INPUT:
                if not self._refill():
                    raise ShortInputError(
                        "unexpected EOF mid-DEFLATE-stream")
            # INSUFFICIENT_SPACE / DONE: loop drains or exits
        return bytes(out)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class GzipDecoder:
    """Streaming multi-member gzip decoder over a readable object.

    Decodes every member of a concatenated gzip stream (RFC 1952 §2.2 —
    what `gzip file1; gzip file2; cat` or GzipEncoder.new_member()
    produce), verifying each member's CRC-32 and ISIZE as it completes.
    """

    def __init__(self, reader) -> None:
        self._reader = reader
        self._in = bytearray()
        self._eof_in = False
        self._win = bytearray()       # inflater window: history + output
        self._drained = 0
        self._crc = 0
        self._size = 0
        self._inflater = None
        self._in_member = False
        self._done = False

    @property
    def finished(self) -> bool:
        return self._done and len(self._win) == self._drained

    def _refill(self) -> bool:
        if self._eof_in:
            return False
        got = self._reader.read(64 * 1024)
        if not got:
            self._eof_in = True
            return False
        self._in += got
        return True

    def _start_member(self) -> bool:
        """Parse the next member header; False at clean end of stream."""
        from . import containers
        while not self._in and not self._eof_in:
            self._refill()
        if not self._in and self._eof_in:
            return False
        while True:
            try:
                start = containers.parse_gzip_header(bytes(self._in))
                break
            except ShortInputError:
                if not self._refill():
                    raise
        del self._in[:start]
        self._inflater = Inflater()
        self._win = bytearray()
        self._drained = 0
        self._crc = 0
        self._size = 0
        self._in_member = True
        return True

    def _finish_member(self) -> None:
        from . import containers
        while len(self._in) < 8:
            if not self._refill():
                raise ShortInputError("gzip footer truncated")
        containers.verify_gzip_footer(bytes(self._in[:8]), self._crc,
                                      self._size)
        del self._in[:8]
        self._in_member = False

    def _slide(self) -> None:
        if self._drained > WINDOW_SIZE and len(self._win) > 2 * WINDOW_SIZE:
            cut = self._drained - WINDOW_SIZE
            del self._win[:cut]
            self._drained -= cut

    def read(self, size: int = -1) -> bytes:
        from .engine import crc32
        out = bytearray()
        while size < 0 or len(out) < size:
            avail = len(self._win) - self._drained
            if avail:
                take = avail if size < 0 else min(avail, size - len(out))
                out += self._win[self._drained: self._drained + take]
                self._drained += take
                self._slide()
                continue
            if self._done:
                break
            if not self._in_member:
                if not self._start_member():
                    self._done = True
                    continue
            prev = len(self._win)
            status, consumed = self._inflater.step(
                bytes(self._in), self._win, len(self._win) + _OUT_CHUNK)
            del self._in[:consumed]
            new = self._win[prev:]
            if new:
                self._crc = crc32(bytes(new), self._crc)
                self._size += len(new)
            if self._inflater.finished:
                self._finish_member()
            elif status == DecompressStatus.SHORT_INPUT:
                if not self._refill():
                    raise ShortInputError(
                        "unexpected EOF mid-gzip-member")
        return bytes(out)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
