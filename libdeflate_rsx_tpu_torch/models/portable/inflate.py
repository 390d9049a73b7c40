"""Portable, resumable DEFLATE decoder (host engine).

This is the bit-exact correctness backbone of the framework — the analog of
the reference's portable decompressor state machine (reference
src/decompress/mod.rs:213-353 states Start/BlockHeader/DynamicHeader/
BlockBody/BlockBodyOffset/UncompressedHeader/UncompressedBody/Done) and its
table-driven Huffman decode (reference src/decompress/mod.rs:1324-1495).
The TPU batch decode path (ops/ + models/) is validated against this engine
and against CPython's zlib.

Design notes (deliberately not a translation):
 - Huffman decoding uses a single-level table of 2^maxlen entries built with
   numpy strided fills (table[rev_code :: 1<<len] = entry) instead of the
   reference's root-table + subtable scheme — simpler, and build cost is
   amortized per block on the host.
 - Resumability is transactional: every step snapshots the bit-reader state
   and rolls back on short input, so the caller re-presents unconsumed bytes.
   Mid-match suspension on output exhaustion keeps a pending (length, offset)
   — the analog of the reference's BlockBodyOffset state.
"""

from __future__ import annotations

import numpy as np

from ...common import (
    BLOCKTYPE_DYNAMIC,
    BLOCKTYPE_STATIC,
    BLOCKTYPE_STORED,
    END_OF_BLOCK,
    LENGTH_SYM_BASE,
    LENGTH_SYM_EXTRA,
    MAX_LITLEN_CODEWORD_LEN,
    MAX_OFFSET_CODEWORD_LEN,
    MAX_PRE_CODEWORD_LEN,
    NUM_LITLEN_SYMS,
    NUM_OFFSET_SYMS,
    NUM_PRECODE_SYMS,
    OFFSET_SYM_BASE,
    OFFSET_SYM_EXTRA,
    PRECODE_PERMUTATION,
    static_litlen_lens,
    static_offset_lens,
)
from ...utils.bits import BitReader
from ...utils.errors import BadDataError, DecompressStatus

# Decode-table entry layout: (symbol << 4) | codeword_len ; 0 == invalid.
_ENTRY_LEN_MASK = 0xF


def build_decode_table(lens: np.ndarray, num_syms: int, max_len: int,
                       allow_single: bool = False) -> np.ndarray:
    """Build a flat 2^max_len LSB-indexed decode table from codeword lengths.

    Rejects over-subscribed AND incomplete codes (zlib / reference
    build_decode_table strictness). With ``allow_single`` (the main
    litlen/offset tables), the RFC 1951 single-code exception applies:
    one code of one bit is accepted, and an entirely empty offset code
    is accepted (errors surface only if an entry is referenced).
    """
    lens = np.asarray(lens[:num_syms], dtype=np.int64)
    counts = np.bincount(lens, minlength=max_len + 1)
    counts[0] = 0
    # Kraft check: over-subscribed is always an error.
    space = 1 << max_len
    used = int(np.sum(counts[1:max_len + 1] << (max_len - np.arange(1, max_len + 1))))
    if used > space:
        raise BadDataError("over-subscribed Huffman code")
    if used < space:
        actual_max = int(np.max(np.nonzero(counts)[0])) if used else 0
        single_ok = allow_single and (used == 0 or actual_max == 1)
        if not single_ok:
            raise BadDataError("incomplete Huffman code")

    table = np.zeros(1 << max_len, dtype=np.int32)
    # canonical first code per length
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code

    order = np.argsort(lens, kind="stable")
    for sym in order:
        l = int(lens[sym])
        if l == 0:
            continue
        code = int(next_code[l])
        next_code[l] += 1
        # bit-reverse the l-bit codeword
        rev = 0
        c = code
        for _ in range(l):
            rev = (rev << 1) | (c & 1)
            c >>= 1
        entry = (int(sym) << 4) | l
        table[rev::(1 << l)] = entry
    return table


class _Tables:
    """Decode tables for the current block."""

    __slots__ = ("litlen", "litlen_bits", "offset", "offset_bits")

    def __init__(self, litlen: np.ndarray, litlen_bits: int,
                 offset: np.ndarray, offset_bits: int) -> None:
        self.litlen = litlen
        self.litlen_bits = litlen_bits
        self.offset = offset
        self.offset_bits = offset_bits


_STATIC_TABLES: _Tables | None = None


def _static_tables() -> _Tables:
    global _STATIC_TABLES
    if _STATIC_TABLES is None:
        _STATIC_TABLES = _Tables(
            build_decode_table(static_litlen_lens(), NUM_LITLEN_SYMS, 9), 9,
            build_decode_table(static_offset_lens(), NUM_OFFSET_SYMS, 5), 5,
        )
    return _STATIC_TABLES


# streaming decoder states
_ST_BLOCK_HEADER = 0
_ST_STORED_BODY = 1
_ST_BLOCK_BODY = 2
_ST_MATCH_BODY = 3     # mid-match, output was full (BlockBodyOffset analog)
_ST_DONE = 4


class Inflater:
    """Resumable raw-DEFLATE decoder.

    feed() consumes compressed bytes and appends decompressed bytes to an
    internal contiguous output (whose tail doubles as the 32 KiB history
    window); the stream wrapper drains and slides it.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._state = _ST_BLOCK_HEADER
        self._final = False
        self._tables: _Tables | None = None
        self._stored_remaining = 0
        self._pending_len = 0
        self._pending_off = 0
        self._bitbuf = 0
        self._bitsleft = 0

    @property
    def finished(self) -> bool:
        return self._state == _ST_DONE

    # -- helpers -----------------------------------------------------------

    def _decode_sym(self, r: BitReader, table: np.ndarray, nbits: int):
        """Decode one symbol; returns symbol or None on short input."""
        v = r.peek_bits(nbits)
        entry = int(table[v])
        l = entry & _ENTRY_LEN_MASK
        if l == 0:
            raise BadDataError("invalid Huffman codeword")
        if l > r.bitsleft:
            # peek_bits refilled as far as the input allows, so this means
            # the codeword extends past the end of the available input.
            return None
        r.consume(l)
        return entry >> 4

    def _read_dynamic_header(self, r: BitReader) -> _Tables | None:
        """Parse HLIT/HDIST/HCLEN + precode-coded lengths. None = short input."""
        hlit = r.try_read_bits(5)
        if hlit is None:
            return None
        hdist = r.try_read_bits(5)
        if hdist is None:
            return None
        hclen = r.try_read_bits(4)
        if hclen is None:
            return None
        num_litlen = hlit + 257
        num_offset = hdist + 1
        num_explicit = hclen + 4
        if num_litlen > NUM_LITLEN_SYMS - 2 or num_offset > 30:
            raise BadDataError("dynamic header symbol counts out of range")
        pre_lens = np.zeros(NUM_PRECODE_SYMS, dtype=np.int32)
        for i in range(num_explicit):
            v = r.try_read_bits(3)
            if v is None:
                return None
            pre_lens[PRECODE_PERMUTATION[i]] = v
        pre_table = build_decode_table(pre_lens, NUM_PRECODE_SYMS,
                                       MAX_PRE_CODEWORD_LEN)
        lens = np.zeros(num_litlen + num_offset, dtype=np.int32)
        i = 0
        while i < num_litlen + num_offset:
            sym = self._decode_sym(r, pre_table, MAX_PRE_CODEWORD_LEN)
            if sym is None:
                return None
            if sym <= 15:
                lens[i] = sym
                i += 1
            elif sym == 16:
                if i == 0:
                    raise BadDataError("precode repeat with no previous length")
                n = r.try_read_bits(2)
                if n is None:
                    return None
                n += 3
                if i + n > len(lens):
                    raise BadDataError("precode repeat overruns lengths")
                lens[i:i + n] = lens[i - 1]
                i += n
            elif sym == 17:
                n = r.try_read_bits(3)
                if n is None:
                    return None
                n += 3
                if i + n > len(lens):
                    raise BadDataError("precode repeat overruns lengths")
                i += n  # already zero
            else:  # 18
                n = r.try_read_bits(7)
                if n is None:
                    return None
                n += 11
                if i + n > len(lens):
                    raise BadDataError("precode repeat overruns lengths")
                i += n
        litlen_lens = np.zeros(NUM_LITLEN_SYMS, dtype=np.int32)
        litlen_lens[:num_litlen] = lens[:num_litlen]
        offset_lens = np.zeros(NUM_OFFSET_SYMS, dtype=np.int32)
        offset_lens[:num_offset] = lens[num_litlen:]
        if litlen_lens[END_OF_BLOCK] == 0:
            raise BadDataError("no end-of-block code")
        return _Tables(
            build_decode_table(litlen_lens, NUM_LITLEN_SYMS,
                               MAX_LITLEN_CODEWORD_LEN, allow_single=True),
            MAX_LITLEN_CODEWORD_LEN,
            build_decode_table(offset_lens, NUM_OFFSET_SYMS,
                               MAX_OFFSET_CODEWORD_LEN, allow_single=True),
            MAX_OFFSET_CODEWORD_LEN,
        )

    # -- main step ---------------------------------------------------------

    def step(self, data: bytes, out: bytearray, max_out: int):
        """Consume from `data`, append to `out` (never past max_out total).

        Returns (status, bytes_consumed). Internal bit-level state persists
        across calls; the caller must drop exactly `bytes_consumed` bytes and
        re-present the rest on SHORT_INPUT.
        """
        r = BitReader(data, 0, self._bitbuf, self._bitsleft)

        def suspend(status: DecompressStatus):
            self._bitbuf = r.bitbuf
            self._bitsleft = r.bitsleft
            return status, r.pos

        while True:
            if self._state == _ST_DONE:
                # Give back whole bytes that were refilled into the bit
                # buffer but never consumed, so `consumed` lands exactly on
                # the end of the DEFLATE stream (footer starts there).
                self._bitbuf = r.bitbuf
                self._bitsleft = r.bitsleft
                return DecompressStatus.DONE, r.pos - (r.bitsleft // 8)

            if self._state == _ST_BLOCK_HEADER:
                save = (r.pos, r.bitbuf, r.bitsleft)
                hdr = r.try_read_bits(3)
                if hdr is None:
                    return suspend(DecompressStatus.SHORT_INPUT)
                self._final = bool(hdr & 1)
                btype = hdr >> 1
                if btype == BLOCKTYPE_STORED:
                    r.align_byte()
                    if r.bits_available() < 32:
                        r.pos, r.bitbuf, r.bitsleft = save
                        return suspend(DecompressStatus.SHORT_INPUT)
                    ln = r.read_bits(16)
                    nlen = r.read_bits(16)
                    if ln != (~nlen & 0xFFFF):
                        raise BadDataError("stored block LEN/NLEN mismatch")
                    self._stored_remaining = ln
                    self._state = _ST_STORED_BODY
                elif btype == BLOCKTYPE_STATIC:
                    self._tables = _static_tables()
                    self._state = _ST_BLOCK_BODY
                elif btype == BLOCKTYPE_DYNAMIC:
                    tables = self._read_dynamic_header(r)
                    if tables is None:
                        r.pos, r.bitbuf, r.bitsleft = save
                        return suspend(DecompressStatus.SHORT_INPUT)
                    self._tables = tables
                    self._state = _ST_BLOCK_BODY
                else:
                    raise BadDataError("reserved block type 3")
                continue

            if self._state == _ST_STORED_BODY:
                while self._stored_remaining:
                    if len(out) >= max_out:
                        return suspend(DecompressStatus.INSUFFICIENT_SPACE)
                    n = min(self._stored_remaining, max_out - len(out))
                    avail = r.bitsleft // 8 + (len(data) - r.pos)
                    if avail == 0:
                        return suspend(DecompressStatus.SHORT_INPUT)
                    n = min(n, avail)
                    out.extend(r.read_bytes(n))
                    self._stored_remaining -= n
                self._state = _ST_DONE if self._final else _ST_BLOCK_HEADER
                continue

            if self._state == _ST_MATCH_BODY:
                length, off = self._pending_len, self._pending_off
                while length:
                    if len(out) >= max_out:
                        self._pending_len = length
                        return suspend(DecompressStatus.INSUFFICIENT_SPACE)
                    out.append(out[len(out) - off])
                    length -= 1
                self._pending_len = 0
                self._state = _ST_BLOCK_BODY
                continue

            # _ST_BLOCK_BODY: symbol decode loop
            t = self._tables
            while True:
                save = (r.pos, r.bitbuf, r.bitsleft)
                sym = self._decode_sym(r, t.litlen, t.litlen_bits)
                if sym is None:
                    return suspend(DecompressStatus.SHORT_INPUT)
                if sym < 256:
                    if len(out) >= max_out:
                        r.pos, r.bitbuf, r.bitsleft = save
                        return suspend(DecompressStatus.INSUFFICIENT_SPACE)
                    out.append(sym)
                    continue
                if sym == END_OF_BLOCK:
                    self._state = _ST_DONE if self._final else _ST_BLOCK_HEADER
                    break
                if sym > 285:
                    raise BadDataError("invalid length symbol")
                li = sym - 257
                extra = r.try_read_bits(int(LENGTH_SYM_EXTRA[li]))
                if extra is None:
                    r.pos, r.bitbuf, r.bitsleft = save
                    return suspend(DecompressStatus.SHORT_INPUT)
                length = int(LENGTH_SYM_BASE[li]) + extra
                osym = self._decode_sym(r, t.offset, t.offset_bits)
                if osym is None:
                    r.pos, r.bitbuf, r.bitsleft = save
                    return suspend(DecompressStatus.SHORT_INPUT)
                if osym > 29:
                    raise BadDataError("invalid offset symbol")
                oextra = r.try_read_bits(int(OFFSET_SYM_EXTRA[osym]))
                if oextra is None:
                    r.pos, r.bitbuf, r.bitsleft = save
                    return suspend(DecompressStatus.SHORT_INPUT)
                off = int(OFFSET_SYM_BASE[osym]) + oextra
                if off > len(out):
                    raise BadDataError("back-reference before start of output")
                # LZ copy (byte-serial semantics handle overlap correctly);
                # bulk-copy the non-overlapping prefix for speed.
                while length:
                    if len(out) >= max_out:
                        self._pending_len = length
                        self._pending_off = off
                        self._state = _ST_MATCH_BODY
                        return suspend(DecompressStatus.INSUFFICIENT_SPACE)
                    room = max_out - len(out)
                    if off >= length and length <= room:
                        src = len(out) - off
                        out.extend(out[src:src + length])
                        length = 0
                    else:
                        n = min(off, length, room)
                        src = len(out) - off
                        out.extend(out[src:src + n])
                        length -= n


def inflate(data: bytes, max_out: int):
    """One-shot raw DEFLATE decode. Returns (output bytes, bytes consumed).

    Raises BadDataError / ShortInputError / InsufficientSpaceError analogs via
    status mapping at the caller (api.py).
    """
    d = Inflater()
    out = bytearray()
    status, consumed = d.step(data, out, max_out)
    return bytes(out), consumed, status
