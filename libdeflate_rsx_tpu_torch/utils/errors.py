"""Typed error surface for the codec.

Mirrors the reference's result enums (CompressResult / DecompressResult,
reference src/decompress/mod.rs:77-85) as Python exceptions plus a
non-raising result enum used by the resumable streaming decoder.
"""

from __future__ import annotations

import enum


class DeflateError(Exception):
    """Base class for all codec errors."""


class BadDataError(DeflateError):
    """The compressed stream is malformed."""


class ShortInputError(DeflateError):
    """Ran out of input mid-stream (truncated data)."""


class InsufficientSpaceError(DeflateError):
    """The provided output buffer is too small."""


class ChecksumMismatchError(BadDataError):
    """zlib Adler-32 or gzip CRC-32 footer did not match the payload."""


class LimitExceededError(DeflateError):
    """Zip-bomb guard tripped (ratio or absolute memory cap)."""


class OverlapError(DeflateError):
    """Input and output buffers overlap (reference src/api.rs:303-314)."""


class LevelError(DeflateError, ValueError):
    """Compression level outside 0..=12."""


class DecompressStatus(enum.Enum):
    """Resumable decoder step status (non-raising streaming protocol)."""

    DONE = 0
    SHORT_INPUT = 1          # need more input bytes; state persisted
    INSUFFICIENT_SPACE = 2   # need more output room; state persisted
