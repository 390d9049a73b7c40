"""Portable DEFLATE encoder (host engine).

Bit-exact-correct host compressor covering the reference's full level
matrix (reference src/compress/mod.rs:476-482,543-602): level 0 stored,
level 1 single-probe hash-table greedy, levels 2-4 hash-chain greedy,
levels 5-9 lazy parsing, levels 10-12 two-pass near-optimal DP parsing —
with per-block stored/static/dynamic type selection by exact bit cost.

Architecture differences from the reference (deliberate, TPU-first):
 - Emission is two-phase everywhere: parsing produces token arrays
   (value, nbits), and a single vectorized numpy scan+scatter packer
   assembles the bitstream. This is the same algorithm the TPU bit-packer
   uses (ops/encode_v2.py), so host and device share one emission model
   instead of the reference's speculative 64-bit bitbuffer writer
   (reference src/compress/bitstream.rs).
 - Huffman codes come from optimal package-merge (models/portable/huffman.py)
   rather than depth redistribution.
"""

from __future__ import annotations

import enum

import numpy as np

from ...common import (
    LENGTH_SYM_BASE,
    LENGTH_SYM_EXTRA,
    LENGTH_TO_SYMBOL,
    MAX_MATCH_LEN,
    MAX_STORED_BLOCK_LEN,
    MIN_MATCH_LEN,
    NUM_LITLEN_SYMS,
    NUM_OFFSET_SYMS,
    NUM_PRECODE_SYMS,
    OFFSET_SYM_BASE,
    OFFSET_SYM_EXTRA,
    OFFSET_TO_SYMBOL,
    PRECODE_PERMUTATION,
    SOFT_MAX_BLOCK_LENGTH,
    WINDOW_SIZE,
    ENC_MAX_LITLEN_LEN,
    ENC_MAX_OFFSET_LEN,
    ENC_MAX_PRE_LEN,
    static_litlen_lens,
    static_offset_lens,
)
from ...utils.errors import LevelError
from .huffman import length_limited_lengths, canonical_codes


class Flush(enum.Enum):
    NONE = 0
    SYNC = 1
    FINISH = 2


# level -> (strategy, max_search_depth, nice_match_len, lazy_lookahead)
# Strategy/depth/nice-length matrix mirroring the reference's behavior
# (reference src/compress/mod.rs:543-602): greedy for 1-4 (level 1 with a
# single-probe table), lazy for 5-9 with increasing depth, DP for 10-12.
_LEVEL_PARAMS = {
    1: ("greedy", 2, 16, 0),
    2: ("greedy", 8, 16, 0),
    3: ("greedy", 24, 32, 0),
    4: ("greedy", 48, 64, 0),
    5: ("lazy", 48, 48, 1),
    6: ("lazy", 128, 128, 1),
    7: ("lazy", 256, 160, 2),
    8: ("lazy", 1024, 258, 2),
    9: ("lazy", 4096, 258, 2),
    10: ("optimal", 100, 258, 0),
    11: ("optimal", 300, 258, 0),
    12: ("optimal", 800, 258, 0),
}

_HASH_BITS = 15
_HASH_MULT = np.uint32(0x9E3779B1)  # golden-ratio multiplicative hash


# ---------------------------------------------------------------------------
# Token buffer: (value, nbits) stream packed once at the end.
# ---------------------------------------------------------------------------


class TokenStream:
    """Accumulates (value ≤56 bits, nbits) tokens; packs LSB-first at finish.

    Tracks the running bit count so stored blocks can compute their byte
    alignment padding exactly. The packer writes each token's shifted value
    into 8 byte planes with scatter-add; token bit ranges are disjoint so
    add == or. The TPU packer (ops/encode_v2.py) uses the same scheme.
    """

    def __init__(self, start_bits: int = 0) -> None:
        self._vals: list[np.ndarray] = []
        self._bits: list[np.ndarray] = []
        self.bitcount = start_bits  # start_bits allows continuation packing

    def put(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self._vals.append(np.array([value], dtype=np.uint64))
        self._bits.append(np.array([nbits], dtype=np.int64))
        self.bitcount += nbits

    def put_arrays(self, values: np.ndarray, nbits: np.ndarray) -> None:
        self._vals.append(values.astype(np.uint64, copy=False))
        self._bits.append(nbits.astype(np.int64, copy=False))
        self.bitcount += int(nbits.sum())

    def align_byte(self) -> None:
        pad = (-self.bitcount) % 8
        if pad:
            self.put(0, pad)

    def put_bytes(self, raw: bytes) -> None:
        assert self.bitcount % 8 == 0, "raw bytes require byte alignment"
        arr = np.frombuffer(raw, dtype=np.uint8)
        self.put_arrays(arr.astype(np.uint64), np.full(len(arr), 8, np.int64))

    def pack(self) -> bytes:
        """Pack all tokens; zero-pads the trailing partial byte."""
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals)
        bits = np.concatenate(self._bits)
        ends = np.cumsum(bits)
        starts = ends - bits
        total = int(ends[-1])
        nbytes = (total + 7) // 8
        out = np.zeros(nbytes + 8, dtype=np.uint8)
        shift = (starts % 8).astype(np.uint64)
        byte0 = (starts // 8).astype(np.int64)
        v = vals << shift  # ≤ 56+7 = 63 bits, fits uint64
        for b in range(8):
            np.add.at(out, byte0 + b, ((v >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8))
        return out[:nbytes].tobytes()


# ---------------------------------------------------------------------------
# Match finding
# ---------------------------------------------------------------------------


def _hash3_array(buf: np.ndarray) -> np.ndarray:
    """15-bit multiplicative hash of every 3-byte window."""
    n = len(buf)
    if n < MIN_MATCH_LEN:
        return np.zeros(0, dtype=np.int64)
    b = buf.astype(np.uint32)
    w = b[:-2] | (b[1:-1] << np.uint32(8)) | (b[2:] << np.uint32(16))
    return ((w * _HASH_MULT) >> np.uint32(32 - _HASH_BITS)).astype(np.int64)


def _matchlen(buf: bytes, j: int, i: int, limit: int) -> int:
    """Length of the common prefix of buf[j:] and buf[i:], capped at limit."""
    l = 0
    while l < limit:
        step = min(64, limit - l)
        if buf[j + l:j + l + step] == buf[i + l:i + l + step]:
            l += step
        else:
            a = buf[j + l:j + l + step]
            b = buf[i + l:i + l + step]
            for k in range(step):
                if a[k] != b[k]:
                    return l + k
            return l + step
    return limit


class _ChainMatchFinder:
    """Hash-chain matchfinder over history+data (host engine).

    The analog of the reference's MatchFinder (reference
    src/compress/matchfinder.rs:721-1107); chains are plain int64 arrays and
    match extension uses C-speed slice comparisons instead of SIMD kernels.
    """

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.hashes = _hash3_array(np.frombuffer(buf, dtype=np.uint8))
        self.head = np.full(1 << _HASH_BITS, -1, dtype=np.int64)
        self.prev = np.full(max(len(buf), 1), -1, dtype=np.int64)

    def insert(self, i: int) -> None:
        if i < len(self.hashes):
            h = self.hashes[i]
            self.prev[i] = self.head[h]
            self.head[h] = i

    def insert_range(self, lo: int, hi: int) -> None:
        for i in range(lo, min(hi, len(self.hashes))):
            self.insert(i)

    def find(self, i: int, depth: int, nice_len: int, max_len: int):
        """Best (length, offset) match at position i, or (0, 0)."""
        if i >= len(self.hashes) or max_len < MIN_MATCH_LEN:
            return 0, 0
        buf = self.buf
        best_len, best_off = 0, 0
        j = self.head[self.hashes[i]]
        limit = i - WINDOW_SIZE
        d = depth
        while j >= 0 and j > limit and d > 0:
            j = int(j)
            # quick filters: candidate must beat current best
            if (best_len == 0 or buf[j + best_len:j + best_len + 1] ==
                    buf[i + best_len:i + best_len + 1]):
                l = _matchlen(buf, j, i, max_len)
                if l > best_len:
                    best_len, best_off = l, i - j
                    if l >= nice_len:
                        break
            j = self.prev[j]
            d -= 1
        if best_len < MIN_MATCH_LEN:
            return 0, 0
        return best_len, best_off

    def find_all(self, i: int, depth: int, max_len: int):
        """Pareto list of (length, offset) with strictly increasing length,
        nearest offset first (for the DP parser)."""
        out = []
        if i >= len(self.hashes) or max_len < MIN_MATCH_LEN:
            return out
        buf = self.buf
        best_len = MIN_MATCH_LEN - 1
        j = self.head[self.hashes[i]]
        limit = i - WINDOW_SIZE
        d = depth
        while j >= 0 and j > limit and d > 0:
            j = int(j)
            if buf[j + best_len:j + best_len + 1] == buf[i + best_len:i + best_len + 1]:
                l = _matchlen(buf, j, i, max_len)
                if l > best_len:
                    out.append((l, i - j))
                    best_len = l
                    if l >= max_len:
                        break
            j = self.prev[j]
            d -= 1
        return out


# ---------------------------------------------------------------------------
# Parsers: produce item arrays (lit byte or (len, off)) per block
# ---------------------------------------------------------------------------


def _parse_greedy(mf: _ChainMatchFinder, start: int, end: int, depth: int,
                  nice_len: int):
    lens, offs = [], []
    buf_len = end
    pos = start
    while pos < end:
        max_len = min(MAX_MATCH_LEN, buf_len - pos)
        l, off = mf.find(pos, depth, nice_len, max_len)
        mf.insert(pos)
        if l >= MIN_MATCH_LEN:
            lens.append(l)
            offs.append(off)
            mf.insert_range(pos + 1, pos + l)
            pos += l
        else:
            lens.append(mf.buf[pos])
            offs.append(0)
            pos += 1
    return np.array(lens, np.int32), np.array(offs, np.int32)


_TOO_FAR_LEN3 = 4096  # a length-3 match far away usually costs more than 3 literals


def _parse_lazy(mf: _ChainMatchFinder, start: int, end: int, depth: int,
                nice_len: int, lookahead: int):
    """Lazy parse with unbounded sequential deferral (levels 5-9).

    Classic scheme: hold the previous position's match; if the current
    position matches longer, emit a literal and keep deferring; otherwise
    commit the held match. `lookahead >= 2` (levels 7-9) also defers on
    equal length when the newer match is closer (cheaper offset).
    """
    lens, offs = [], []
    buf_len = end
    pos = start
    prev_len, prev_off = 0, 0
    while pos < end:
        max_len = min(MAX_MATCH_LEN, buf_len - pos)
        l, off = mf.find(pos, depth, nice_len, max_len)
        mf.insert(pos)
        if l == MIN_MATCH_LEN and off > _TOO_FAR_LEN3:
            l, off = 0, 0
        if prev_len >= MIN_MATCH_LEN:
            better = l > prev_len or (lookahead >= 2 and l == prev_len
                                      and 0 < off < prev_off)
            if better and prev_len < nice_len:
                # defer again: the byte before the new match is a literal
                lens.append(mf.buf[pos - 1])
                offs.append(0)
                prev_len, prev_off = l, off
                pos += 1
                continue
            # commit the held match at pos-1
            lens.append(prev_len)
            offs.append(prev_off)
            mf.insert_range(pos + 1, pos - 1 + prev_len)
            pos = pos - 1 + prev_len
            prev_len, prev_off = 0, 0
            continue
        if l >= MIN_MATCH_LEN:
            if l >= nice_len:
                # long enough: take it immediately, no deferral
                lens.append(l)
                offs.append(off)
                mf.insert_range(pos + 1, pos + l)
                pos += l
            else:
                prev_len, prev_off = l, off
                pos += 1
        else:
            lens.append(mf.buf[pos])
            offs.append(0)
            pos += 1
    if prev_len >= MIN_MATCH_LEN:
        # held match extends to the block end (pos == end)
        lens.append(prev_len)
        offs.append(prev_off)
    return np.array(lens, np.int32), np.array(offs, np.int32)


def _static_cost_tables():
    """Bit cost per litlen symbol / offset symbol under the static code,
    including extra bits (used as the pass-1 DP cost model)."""
    ll = static_litlen_lens().astype(np.int64)
    ll_cost = ll.copy()
    ll_cost[257:286] += LENGTH_SYM_EXTRA
    off_cost = static_offset_lens().astype(np.int64)[:30] + OFFSET_SYM_EXTRA
    return ll_cost, off_cost


def _parse_optimal(mf: _ChainMatchFinder, start: int, end: int, depth: int,
                   nice_len: int, passes: int = 2):
    """Two-pass near-optimal DP parse (levels 10-12).

    Pass 1 uses static-code costs; later passes refresh costs from the
    Huffman code implied by the previous pass's symbol frequencies
    (the reference's scheme, reference src/compress/mod.rs:1586-1773).
    """
    n = end - start
    buf = mf.buf
    # Collect Pareto matches per position (chain walk, all-matches visitor).
    cand: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    pos = start
    while pos < end:
        max_len = min(MAX_MATCH_LEN, end - pos)
        matches = mf.find_all(pos, depth, max_len)
        mf.insert(pos)
        cand[pos - start] = matches
        if matches and matches[-1][0] >= nice_len:
            # Skip interior of very long matches (they will be taken whole).
            skip_to = pos + matches[-1][0]
            mf.insert_range(pos + 1, min(skip_to, end))
            for q in range(pos + 1, min(skip_to, end)):
                cand[q - start] = []
            pos = skip_to
        else:
            pos += 1

    ll_cost, off_cost_by_sym = _static_cost_tables()
    off_sym_cost = off_cost_by_sym  # per offset symbol

    lens_out = offs_out = None
    for _ in range(max(passes, 1)):
        lit_cost = ll_cost[:256]
        len_cost_by_len = ll_cost[LENGTH_TO_SYMBOL[3:MAX_MATCH_LEN + 1]]  # 3..258
        cost = np.zeros(n + 1, dtype=np.int64)
        choice_len = np.ones(n, dtype=np.int32)
        choice_off = np.zeros(n, dtype=np.int32)
        for i in range(n - 1, -1, -1):
            b = buf[start + i]
            best = lit_cost[b] + cost[i + 1]
            bl, bo = 1, 0
            for (l, off) in cand[i]:
                oc = off_sym_cost[OFFSET_TO_SYMBOL[off]]
                sub = (len_cost_by_len[0:l - 2] + oc
                       + cost[i + 3:i + l + 1])
                k = int(np.argmin(sub))
                if sub[k] < best:
                    best = int(sub[k])
                    bl, bo = k + 3, off
            cost[i] = best
            choice_len[i] = bl
            choice_off[i] = bo
        # Walk the chosen path.
        lens, offs = [], []
        i = 0
        while i < n:
            if choice_off[i] == 0:
                lens.append(buf[start + i])
                offs.append(0)
                i += 1
            else:
                lens.append(int(choice_len[i]))
                offs.append(int(choice_off[i]))
                i += choice_len[i]
        lens_out = np.array(lens, np.int32)
        offs_out = np.array(offs, np.int32)
        # Refresh the cost model from this pass's actual code.
        ll_f, off_f = _block_freqs(lens_out, offs_out)
        ll_lens = length_limited_lengths(ll_f, ENC_MAX_LITLEN_LEN).astype(np.int64)
        of_lens = length_limited_lengths(off_f, ENC_MAX_OFFSET_LEN).astype(np.int64)
        ll_lens[ll_lens == 0] = ENC_MAX_LITLEN_LEN + 2   # unused: discourage
        of_lens[of_lens == 0] = ENC_MAX_OFFSET_LEN + 2
        ll_cost = ll_lens.copy()
        ll_cost[257:286] += LENGTH_SYM_EXTRA
        off_sym_cost = of_lens[:30] + OFFSET_SYM_EXTRA
    return lens_out, offs_out


# ---------------------------------------------------------------------------
# Block emission
# ---------------------------------------------------------------------------


def _block_freqs(lens: np.ndarray, offs: np.ndarray):
    is_match = offs > 0
    ll_syms = np.where(is_match, LENGTH_TO_SYMBOL[np.minimum(lens, MAX_MATCH_LEN)],
                       lens).astype(np.int64)
    ll_f = np.bincount(ll_syms, minlength=NUM_LITLEN_SYMS)
    ll_f[256] += 1  # EOB
    off_syms = OFFSET_TO_SYMBOL[offs[is_match]]
    off_f = np.bincount(off_syms, minlength=NUM_OFFSET_SYMS)
    return ll_f, off_f


def _ensure_complete(lens_arr: np.ndarray) -> np.ndarray:
    """A 1-symbol code is under-subscribed; give a second symbol length 1 so
    strict decoders (zlib's inflate_table) accept the code as complete."""
    nz = np.nonzero(lens_arr)[0]
    if len(nz) == 1:
        dummy = 0 if nz[0] != 0 else 1
        lens_arr = lens_arr.copy()
        lens_arr[dummy] = 1
        lens_arr[nz[0]] = 1
    return lens_arr


def _precode_rle(all_lens: np.ndarray):
    """RLE-encode litlen+offset code lengths into precode symbols.

    Returns (syms, extra_vals, extra_bits) arrays per RFC 1951 §3.2.7.
    """
    syms, ev, eb = [], [], []
    i = 0
    n = len(all_lens)
    prev = -1
    while i < n:
        v = int(all_lens[i])
        run = 1
        while i + run < n and all_lens[i + run] == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                syms.append(18); ev.append(take - 11); eb.append(7)
                r -= take
            while r >= 3:
                take = min(r, 10)
                syms.append(17); ev.append(take - 3); eb.append(3)
                r -= take
            for _ in range(r):
                syms.append(0); ev.append(0); eb.append(0)
        else:
            r = run
            if v != prev:
                syms.append(v); ev.append(0); eb.append(0)
                r -= 1
            while r >= 3:
                take = min(r, 6)
                syms.append(16); ev.append(take - 3); eb.append(2)
                r -= take
            for _ in range(r):
                syms.append(v); ev.append(0); eb.append(0)
        prev = v
        i += run
    return (np.array(syms, np.int64), np.array(ev, np.int64),
            np.array(eb, np.int64))


def _emit_body(ts: TokenStream, lens: np.ndarray, offs: np.ndarray,
               ll_lens: np.ndarray, ll_codes: np.ndarray,
               of_lens: np.ndarray, of_codes: np.ndarray) -> None:
    """Vectorized sequence emission: compose each item's up-to-48-bit field."""
    is_match = offs > 0
    ll_syms = np.where(is_match, LENGTH_TO_SYMBOL[np.minimum(lens, MAX_MATCH_LEN)],
                       lens).astype(np.int64)
    v = ll_codes[ll_syms].astype(np.uint64)
    nb = ll_lens[ll_syms].astype(np.uint64)
    # length extra bits
    li = np.where(is_match, ll_syms - 257, 0)
    lextra_bits = np.where(is_match, LENGTH_SYM_EXTRA[li], 0).astype(np.uint64)
    lextra_val = np.where(is_match, lens - LENGTH_SYM_BASE[li], 0).astype(np.uint64)
    v |= lextra_val << nb
    nb += lextra_bits
    # offset code + extra
    osym = np.where(is_match, OFFSET_TO_SYMBOL[np.maximum(offs, 1)], 0)
    ocode = np.where(is_match, of_codes[osym], 0).astype(np.uint64)
    olen = np.where(is_match, of_lens[osym], 0).astype(np.uint64)
    v |= ocode << nb
    nb += olen
    oextra_bits = np.where(is_match, OFFSET_SYM_EXTRA[osym], 0).astype(np.uint64)
    oextra_val = np.where(is_match, offs - OFFSET_SYM_BASE[osym], 0).astype(np.uint64)
    v |= oextra_val << nb
    nb += oextra_bits
    ts.put_arrays(v, nb.astype(np.int64))
    # end of block
    ts.put(int(ll_codes[256]), int(ll_lens[256]))


def _emit_stored(ts: TokenStream, raw: bytes, final: bool) -> None:
    n = len(raw)
    pos = 0
    while True:
        chunk = min(n - pos, MAX_STORED_BLOCK_LEN)
        last = pos + chunk == n
        ts.put((1 if (final and last) else 0) | (0 << 1), 3)
        ts.align_byte()
        ts.put(chunk, 16)
        ts.put((~chunk) & 0xFFFF, 16)
        ts.put_bytes(raw[pos:pos + chunk])
        pos += chunk
        if last:
            break


def _dynamic_header_tokens(ll_lens: np.ndarray, of_lens: np.ndarray):
    """Build dynamic-header token arrays; returns (values, nbits, total_bits)."""
    num_litlen = max(257, int(np.max(np.nonzero(ll_lens)[0])) + 1)
    nz_off = np.nonzero(of_lens)[0]
    num_offset = max(1, (int(nz_off[-1]) + 1) if len(nz_off) else 1)
    all_lens = np.concatenate([ll_lens[:num_litlen], of_lens[:num_offset]])
    psyms, pev, peb = _precode_rle(all_lens)
    pf = np.bincount(psyms, minlength=NUM_PRECODE_SYMS)
    p_lens = _ensure_complete(length_limited_lengths(pf, ENC_MAX_PRE_LEN))
    p_codes = canonical_codes(p_lens)
    # HCLEN: trim trailing zeros in permutation order (min 4 entries)
    perm_lens = p_lens[PRECODE_PERMUTATION]
    num_explicit = NUM_PRECODE_SYMS
    while num_explicit > 4 and perm_lens[num_explicit - 1] == 0:
        num_explicit -= 1
    vals = [np.array([num_litlen - 257, num_offset - 1, num_explicit - 4],
                     np.uint64)]
    bits = [np.array([5, 5, 4], np.int64)]
    vals.append(perm_lens[:num_explicit].astype(np.uint64))
    bits.append(np.full(num_explicit, 3, np.int64))
    # precode-coded lengths with extras fused per token
    pv = p_codes[psyms].astype(np.uint64)
    pn = p_lens[psyms].astype(np.uint64)
    pv |= pev.astype(np.uint64) << pn
    pn += peb.astype(np.uint64)
    vals.append(pv)
    bits.append(pn.astype(np.int64))
    values = np.concatenate(vals)
    nbits = np.concatenate(bits)
    return values, nbits, int(nbits.sum())


def emit_block(ts: TokenStream, data: bytes, start: int, end: int,
               lens: np.ndarray, offs: np.ndarray, final: bool) -> None:
    """Emit one block choosing stored/static/dynamic by exact bit cost."""
    ll_f, off_f = _block_freqs(lens, offs)
    # dynamic code
    dyn_ll = _ensure_complete(length_limited_lengths(ll_f, ENC_MAX_LITLEN_LEN))
    dyn_of = _ensure_complete(length_limited_lengths(off_f, ENC_MAX_OFFSET_LEN))
    hdr_vals, hdr_bits, hdr_cost = _dynamic_header_tokens(dyn_ll, dyn_of)

    extra_ll = np.zeros(NUM_LITLEN_SYMS, np.int64)
    extra_ll[257:286] = LENGTH_SYM_EXTRA
    extra_of = OFFSET_SYM_EXTRA.astype(np.int64)
    body_dyn = int(np.sum(ll_f * (dyn_ll + extra_ll))
                   + np.sum(off_f[:30] * (dyn_of[:30] + extra_of)))
    st_ll = static_litlen_lens()
    st_of = static_offset_lens()
    body_static = int(np.sum(ll_f * (st_ll + extra_ll))
                      + np.sum(off_f[:30] * (st_of[:30] + extra_of)))
    n_raw = end - start
    cost_dynamic = 3 + hdr_cost + body_dyn
    cost_static = 3 + body_static
    # stored cost includes alignment (position-dependent; use worst pad)
    cost_stored = (40 + 8 * MAX_STORED_BLOCK_LEN) * (n_raw // MAX_STORED_BLOCK_LEN) \
        + 40 + 8 * (n_raw % MAX_STORED_BLOCK_LEN)

    if cost_stored < min(cost_dynamic, cost_static):
        _emit_stored(ts, data[start:end], final)
        return
    if cost_static <= cost_dynamic:
        ts.put((1 if final else 0) | (1 << 1), 3)
        _emit_body(ts, lens, offs, st_ll, canonical_codes(st_ll),
                   st_of, canonical_codes(st_of))
    else:
        ts.put((1 if final else 0) | (2 << 1), 3)
        ts.put_arrays(hdr_vals, hdr_bits)
        _emit_body(ts, lens, offs, dyn_ll, canonical_codes(dyn_ll),
                   dyn_of, canonical_codes(dyn_of))


# ---------------------------------------------------------------------------
# Top-level host compressor
# ---------------------------------------------------------------------------


def deflate_host(data: bytes, level: int, flush: Flush = Flush.FINISH,
                 history: bytes = b"", start_bits: int = 0) -> bytes:
    """Compress `data` to a raw DEFLATE stream on the host.

    `history` provides LZ dictionary context (not emitted). With
    Flush.SYNC the stream ends with an empty stored block and is
    byte-aligned, so independently compressed chunks byte-concatenate into
    one valid stream — the reference's parallel-chunk join (reference
    src/compress/mod.rs:662-681).
    """
    if not (0 <= level <= 12):
        raise LevelError(f"level {level} outside 0..=12")
    ts = TokenStream(start_bits)
    final = flush == Flush.FINISH

    if level == 0 or len(data) == 0:
        if len(data) == 0 and not final:
            pass  # nothing but maybe a sync block below
        else:
            _emit_stored(ts, data, final)
    else:
        strategy, depth, nice_len, lookahead = _LEVEL_PARAMS[level]
        if len(history) > WINDOW_SIZE:
            history = history[-WINDOW_SIZE:]
        buf = history + data
        mf = _ChainMatchFinder(buf)
        mf.insert_range(0, len(history))
        start = len(history)
        # split into blocks of at most SOFT_MAX_BLOCK_LENGTH
        bstart = start
        while bstart < len(buf):
            bend = min(bstart + SOFT_MAX_BLOCK_LENGTH, len(buf))
            if strategy == "greedy":
                lens, offs = _parse_greedy(mf, bstart, bend, depth, nice_len)
            elif strategy == "lazy":
                lens, offs = _parse_lazy(mf, bstart, bend, depth, nice_len,
                                         lookahead)
            else:
                lens, offs = _parse_optimal(mf, bstart, bend, depth, nice_len)
            emit_block(ts, buf, bstart, bend, lens, offs,
                       final and bend == len(buf))
            bstart = bend

    if flush == Flush.SYNC:
        # empty stored block, leaves the stream byte-aligned
        ts.put(0, 3)
        ts.align_byte()
        ts.put(0x0000, 16)
        ts.put(0xFFFF, 16)
    return ts.pack()
