"""zlib (RFC 1950) and gzip (RFC 1952) container framing.

Encode/decode of headers and checksum footers around raw DEFLATE payloads
(the analog of reference src/compress/mod.rs:2248-2357 on the encode side
and src/decompress/mod.rs:1074-1255 on the decode side).
"""

from __future__ import annotations

import struct

from .common import (
    GZIP_CM_DEFLATE,
    GZIP_FCOMMENT,
    GZIP_FEXTRA,
    GZIP_FHCRC,
    GZIP_FNAME,
    GZIP_MAGIC,
    GZIP_OS_UNKNOWN,
    GZIP_RESERVED_FLAGS,
    ZLIB_CINFO_32K,
    ZLIB_CM_DEFLATE,
)
from .utils.errors import BadDataError, ChecksumMismatchError, ShortInputError


def zlib_header(level: int) -> bytes:
    """2-byte zlib header with FLEVEL mapped from the compression level."""
    cmf = ZLIB_CM_DEFLATE | (ZLIB_CINFO_32K << 4)
    if level < 2:
        flevel = 0
    elif level < 6:
        flevel = 1
    elif level == 6:
        flevel = 2
    else:
        flevel = 3
    flg = flevel << 6
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def zlib_footer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)


def parse_zlib_header(data: bytes) -> int:
    """Validate the 2-byte zlib header; returns payload start offset."""
    if len(data) < 2:
        raise ShortInputError("zlib header truncated")
    cmf, flg = data[0], data[1]
    if (cmf * 256 + flg) % 31 != 0:
        raise BadDataError("zlib header check bits invalid")
    if (cmf & 0x0F) != ZLIB_CM_DEFLATE:
        raise BadDataError("zlib compression method not deflate")
    if (cmf >> 4) > ZLIB_CINFO_32K:
        raise BadDataError("zlib window size too large")
    if flg & 0x20:
        raise BadDataError("zlib preset dictionary not supported")
    return 2


def verify_zlib_footer(data: bytes, adler: int) -> None:
    if len(data) < 4:
        raise ShortInputError("zlib Adler-32 footer truncated")
    expect = struct.unpack(">I", data[:4])[0]
    if expect != (adler & 0xFFFFFFFF):
        raise ChecksumMismatchError(
            f"zlib Adler-32 mismatch: stored {expect:#010x}, computed {adler:#010x}")


def gzip_header(level: int) -> bytes:
    """Minimal 10-byte gzip header; XFL reflects the compression level."""
    if level >= 9:
        xfl = 2       # maximum compression
    elif level <= 1:
        xfl = 4       # fastest
    else:
        xfl = 0
    return GZIP_MAGIC + bytes([GZIP_CM_DEFLATE, 0]) + b"\x00\x00\x00\x00" + \
        bytes([xfl, GZIP_OS_UNKNOWN])


def gzip_footer(crc: int, isize: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def parse_gzip_header(data: bytes) -> int:
    """Parse the gzip header incl. FEXTRA/FNAME/FCOMMENT/FHCRC; returns
    payload start offset."""
    if len(data) < 10:
        raise ShortInputError("gzip header truncated")
    if data[:2] != GZIP_MAGIC:
        raise BadDataError("bad gzip magic")
    if data[2] != GZIP_CM_DEFLATE:
        raise BadDataError("gzip compression method not deflate")
    flg = data[3]
    if flg & GZIP_RESERVED_FLAGS:
        raise BadDataError("gzip reserved flag bits set")
    pos = 10
    if flg & GZIP_FEXTRA:
        if len(data) < pos + 2:
            raise ShortInputError("gzip FEXTRA truncated")
        xlen = data[pos] | (data[pos + 1] << 8)
        pos += 2 + xlen
        if len(data) < pos:
            raise ShortInputError("gzip FEXTRA truncated")
    if flg & GZIP_FNAME:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise ShortInputError("gzip FNAME unterminated")
        pos = end + 1
    if flg & GZIP_FCOMMENT:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise ShortInputError("gzip FCOMMENT unterminated")
        pos = end + 1
    if flg & GZIP_FHCRC:
        if len(data) < pos + 2:
            raise ShortInputError("gzip FHCRC truncated")
        from .models.portable.checksums import crc32_host
        hcrc = data[pos] | (data[pos + 1] << 8)
        if (crc32_host(data[:pos]) & 0xFFFF) != hcrc:
            raise ChecksumMismatchError("gzip header CRC mismatch")
        pos += 2
    return pos


def verify_gzip_footer(data: bytes, crc: int, isize: int) -> None:
    if len(data) < 8:
        raise ShortInputError("gzip footer truncated")
    stored_crc, stored_isize = struct.unpack("<II", data[:8])
    if stored_crc != (crc & 0xFFFFFFFF):
        raise ChecksumMismatchError(
            f"gzip CRC-32 mismatch: stored {stored_crc:#010x}, computed {crc:#010x}")
    if stored_isize != (isize & 0xFFFFFFFF):
        raise BadDataError("gzip ISIZE mismatch")
