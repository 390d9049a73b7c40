"""The emit step (ops/emit.py): its plain version on CPU tensors against
the JAX package's emit_pack and static coding, and a numpy model of the
emit kernel's decomposition (csrc/emit.cu) against the plain version.
Tolerance: exact equality (the outputs are integers and bytes).

The kernel itself runs only on a card (tests/test_torch_cuda.py). The
model follows the kernel step by step:
- a block's lanes in tiles of 2,048 (64 rows), a tile a step, the tiles
  taken in ticket order (two steps ahead) by a few persistent blocks
  whose steps a seeded scheduler interleaves;
- each tile's sel, lit and byte rows read as the kernel reads them from
  the rows' addresses: a stage buffer (garbage outside the copy) filled
  by the bulk copy, rounded out to 16 bytes where the rows' storage
  allows it, else its aligned middle, the other lanes from memory; so
  rows that start off 16 bytes, and column views, are read as they are;
- each lane's literal, each sel lane's match token and riding offset
  from the low words of its (ml, dist), the ride into the next lane in
  the thread, from the thread before, into a warp's first lane from the
  staged flag and the gathered distance of the lane before it, into a
  tile's first lane from the sel flag's aligned word and the distance
  before the tile; a thread past the block's last row takes none;
- each row's 4 thread sums scanned, the tile's row sums scanned two a
  lane by warp 0, its aggregate (its block's first tile: its inclusive
  prefix) published when it is coded, and its base taken by the
  decoupled look-back (32 status words at a time, nearest first, waiting
  while a word up to the nearest inclusive one is 0) one step later;
- the tokens' low and high words summed in registers and added mod 2^32
  into each row's frame words a touched word at a time, bits past the
  frame dropped, the row's bytes by funnel shifts of the frame words.
Mutated models (a tile's base off by one tile, no ride into a tile's
first lane, a thread past the block taking the last lane's ride, a
look-back that stops at an aggregate) each disagree with the plain
version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import (EMIT_UNALIGNED, emit_cases, emit_chunk_cases,
                          emit_random_cases)
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu.ops import static_codes as jsc
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as pgd
from libdeflate_rsx_tpu_torch.models import greedy_static as pgs
from libdeflate_rsx_tpu_torch.ops import emit as em
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import encode_v2 as pev
from tests.conftest import make_corpus

torch.set_num_threads(2)
BLOCK = 16384
KINDS = ("text", "random", "zeros")
K = 8                   # lanes a thread of csrc/emit.cu
TPR = 32 // K           # threads a row
NT = 256                # threads a block
TR = 64                 # rows a tile
TL = TR * 32            # lanes a tile
RPW = 8                 # rows a warp
WL = 32 * K             # lanes a warp
STAGE_BYTES = TL + 32   # a tile's stage buffer of one array
MASK = (1 << 32) - 1


def eq(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def tensors(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


# ------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def flows():
    """Per kind: the JAX package's emit inputs of the L6 and L4 tiers
    (analyze, then its package-merge tables) and the L1 tier's
    tokens (find_matches_v2, extend_runs, select_tokens), with its
    encode_rows_static outputs."""
    out = {}
    for kind in KINDS:
        data = make_corpus(kind, 40000, seed=3)
        arr, valid, hs, finals, _ = pgd.split_blocks_hist(data, BLOCK)
        a = jed.jit_analyze_l6(BLOCK)(jnp.asarray(arr), jnp.asarray(valid),
                                      jnp.asarray(hs))
        a = [np.asarray(x) for x in a]
        ll, of, _, hb = jed.build_tables_host(a[4], a[5], finals)
        l6 = (arr[:, ped.HIST:], *a[:4], ll, of, hb)
        arr, valid, finals, _ = pgs.split_blocks(data, BLOCK)
        a = [np.asarray(x) for x in jed.jit_analyze(BLOCK)(
            jnp.asarray(arr), jnp.asarray(valid))]
        ll, of, _, hb = jed.build_tables_host(a[4], a[5], finals)
        l4 = (arr, *a[:4], ll, of, hb)

        def tokens(d, v):
            ml, dist = jev.find_matches_v2(d, v, BLOCK)
            ml = jev.extend_runs(ml, dist, v)
            ml, sel, lit = jev.select_tokens(ml, dist, v)
            return ml, dist, sel, lit
        t = jax.jit(jax.vmap(tokens))(jnp.asarray(arr), jnp.asarray(valid))
        enc = jev.jit_encoder(BLOCK)(jnp.asarray(arr), jnp.asarray(valid),
                                     jnp.asarray(finals))
        l1 = ((arr, *(np.asarray(x) for x in t)),
              [np.asarray(x) for x in enc])
        out[kind] = {"l6": l6, "l4": l4, "l1": l1}
    return out


def port_dynamic(data, ml, dist, sel, lit, ll, of, hb, s):
    ml, dist = ml.astype(np.int64), dist.astype(np.int64)
    return em.emit(*tensors(data, ml, dist, sel, lit), s,
                   *tensors(ll.astype(np.int64), of.astype(np.int64),
                            hb.astype(np.int64)))


@pytest.mark.parametrize("tier", ["l6", "l4"])
@pytest.mark.parametrize("kind", KINDS)
def test_dynamic_emit_equals_jax_emit_pack(kind, tier, flows):
    """emit with tables (CPU tensors: the plain version) on the JAX
    package's own analyze outputs and tables equals its emit_pack."""
    args = flows[kind][tier]
    want = jed.jit_emit(BLOCK)(*(jnp.asarray(x) for x in args))
    got = port_dynamic(*args, BLOCK)
    for g, w in zip(got, want, strict=True):
        eq(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_static_emit_equals_jax_encode_rows_static(kind, flows):
    """emit without tables on the JAX package's own L1 tokens gives its
    encode_rows_static's rows, byte offsets and bit counts."""
    (arr, ml, dist, sel, lit), want = flows[kind]["l1"]
    rows, byte_off, row_bit0, end_bits = em.emit(
        *tensors(arr, ml.astype(np.int64), dist.astype(np.int64), sel, lit),
        BLOCK)
    eq(rows, want[0])
    eq(byte_off, want[1])
    rowbits = np.diff(np.concatenate([row_bit0.numpy(),
                                      end_bits.numpy()[:, None]], 1), axis=1)
    eq(rowbits, want[2])
    eq(end_bits + 7, want[3])


def jax_static_emit(data, ml, dist, sel, lit, s):
    """The JAX package's static coding and packing, the lines of its
    encode_rows_static after the selection (ops/encode_v2.py:363-370)."""
    def one(d, m, di, se, li):
        lv, ln = jsc.literal_code(d[:s])
        mv, mn = jsc.match_token(jnp.maximum(m, 4), jnp.clip(di, 1, 32768))
        val = jnp.where(se, mv, jnp.where(li, lv, jnp.uint32(0)))
        nb = jnp.where(se, mn, jnp.where(li, ln, jnp.uint32(0))).astype(
            jnp.int32)
        return jev.pack_rows(val, nb, 3, jev.ROW_OUT)
    return jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (
        data, ml.astype(np.int32), dist.astype(np.int32), sel, lit)))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_emit_equals_jax_on_the_trap_arrays(mode):
    """The seeded trap arrays of tests/_port_corpus.emit_cases (matches on
    a row's, a tile's and the block's last lane, rows filled to their
    frame, the longest lengths and distances, inactive lanes, no tokens,
    blocks starting at bits 0..65,538)."""
    _, data, ml, dist, sel, lit, ll, of, start = emit_cases()
    s = ml.shape[1]
    if mode == "dynamic":
        want = jed.jit_emit(s)(*(jnp.asarray(x) for x in (
            data, ml.astype(np.int32), dist.astype(np.int32), sel, lit,
            ll.astype(np.uint32), of.astype(np.uint32),
            start.astype(np.int32))))
        got = port_dynamic(data, ml, dist, sel, lit, ll, of, start, s)
    else:
        want = jax_static_emit(data, ml, dist, sel, lit, s)
        got = em.emit(*tensors(data, ml, dist, sel, lit), s)
    for g, w in zip(got, want, strict=True):
        eq(g, w)


def test_plain_versions_are_the_port_graphs():
    """emit on CPU tensors is emit_pack_plain with tables and
    emit_static_plain without; encode_dynamic.emit_pack goes through
    it."""
    _, data, ml, dist, sel, lit, ll, of, start = emit_cases()
    s = ml.shape[1]
    lanes = tensors(data, ml, dist, sel, lit)
    tabs = tensors(ll, of, start)
    before = em.LAUNCHES
    for got, want in ((em.emit(*lanes, s, *tabs),
                       ped.emit_pack_plain(*lanes, *tabs, s)),
                      (ped.emit_pack(*lanes, *tabs, s),
                       ped.emit_pack_plain(*lanes, *tabs, s)),
                      (em.emit(*lanes, s),
                       pev.emit_static_plain(*lanes, s))):
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert em.LAUNCHES == before


# ------------------------------------------------ the kernel's decomposition
def bsr(x):
    x = np.maximum(np.asarray(x, np.int64), 1)
    return np.floor(np.log2(x)).astype(np.int64)


def bitrev(v, n):
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    for i in range(16):
        out |= ((v >> i) & 1) << (15 - i)
    return out >> (16 - np.asarray(n, np.int64))


def length_sym(length):
    n = length - 3
    eb = np.where(n < 8, 0, bsr(n) - 2)
    sym = np.where(n < 8, 257 + n, 257 + (eb << 2) + (n >> eb))
    extra = n & ((1 << eb) - 1)
    top = length == 258
    return (np.where(top, 285, sym), np.where(top, 0, extra),
            np.where(top, 0, eb))


def offset_sym(dist):
    o = dist - 1
    b = bsr(o)
    sym = np.where(o < 4, o, 2 * b + ((o >> np.maximum(b - 1, 0)) & 1))
    eb = np.maximum(sym // 2 - 1, 0)
    base = np.where(sym < 4, sym, (2 + (sym & 1)) << eb)
    return sym, o - base, eb


def low_word(x):
    """The low 32 bits of int64 values as the int32 the kernel codes from."""
    return (np.asarray(x, np.int64) & MASK).astype(np.uint32).view(np.int32)


class Rows:
    """A byte array's rows in memory as the kernel addresses them: lane i
    of row b at byte b * stride + first + i of a buffer (the tensor's
    storage) whose other bytes are garbage; x (b, w) holds the rows'
    bytes, stride = first + w + extra."""

    def __init__(self, x, s, first=0, extra=0, seed=0):
        b, w = x.shape
        self.first, self.stride = first, first + w + extra
        rng = np.random.default_rng(seed)
        self.mem = rng.integers(0, 256, b * self.stride, dtype=np.uint8)
        for i in range(b):
            at = i * self.stride + first
            self.mem[at:at + w] = x[i]
        # ops/emit._round_ok: the rows rounded out to 16 bytes stay inside
        end = (b - 1) * self.stride + first + s
        self.round = -(-end // 16) * 16 <= self.mem.size

    def tile(self, b, p0, n, rng):
        """Lanes [p0, p0 + n) of row b as the kernel's threads read them:
        the bulk copy into a stage buffer of garbage, the lanes it missed
        from memory (span_of, lanes8 and lane1 of csrc/emit.cu)."""
        addr = b * self.stride + self.first + p0
        o = addr & 15
        if self.round:
            lo, hi = 0, (o + n + 15) & ~15 if n else 0
        else:
            lo16, hi16 = (addr + 15) & ~15, (addr + n) & ~15
            lo = lo16 - (addr - o)
            hi = hi16 - (addr - o) if hi16 > lo16 else lo
        assert addr - o + lo >= 0 and addr - o + hi <= self.mem.size
        stage = rng.integers(0, 256, STAGE_BYTES, dtype=np.uint8)
        stage[lo:hi] = self.mem[addr - o + lo:addr - o + hi]
        k = np.arange(n) + o
        inside = (k >= lo) & (k < hi)
        return np.where(inside, stage[np.minimum(k, STAGE_BYTES - 1)],
                        self.mem[addr + np.arange(n)]).astype(np.int64)

    def byte(self, b, p):
        """Lane p's byte read through its aligned 4-byte word (the lane
        before a tile)."""
        addr = b * self.stride + self.first + p
        word = self.mem[addr & ~3:(addr & ~3) + 4]
        return int(word[addr & 3])


def match_tokens(ml, dist, ll, of):
    """A sel lane's (val, nb) and, in the dynamic mode, the offset part
    (rv, rn) that rides the next lane, from the low words of (ml, dist)
    (dynamic_token, static_token and ride of csrc/emit.cu)."""
    m = np.maximum(ml.astype(np.int64), 4)
    d = np.clip(dist.astype(np.int64), 1, 32768)
    lsym, lev, leb = length_sym(m)
    dsym, dev, deb = offset_sym(d)
    if ll is None:
        sym8 = lsym >= 280
        nb = np.where(sym8, 8, 7)
        mv = bitrev(np.where(sym8, 0xC0 + lsym - 280, lsym - 256), nb)
        mv |= lev << nb
        nb = nb + leb
        mv |= bitrev(dsym, 5) << nb
        nb = nb + 5
        mv |= dev << nb
        return mv & MASK, nb + deb, None, None
    ent = ll[np.minimum(lsym, 287)].astype(np.int64)
    clen = ent >> 16
    dent = of[dsym].astype(np.int64)
    dlen = dent >> 16
    return (((ent & 0xFFFF) | (lev << clen)) & MASK, clen + leb,
            ((dent & 0xFFFF) | (dev << dlen)) & MASK, dlen + deb)


def ride_of(flag, dist, of):
    """The offset part that a lane hands on (nothing unless its sel flag
    is set), from the low word of its distance."""
    if not flag:
        return 0, 0
    dsym, dev, deb = offset_sym(np.clip(np.array([dist], np.int64), 1,
                                        32768))
    dent = int(of[dsym[0]])
    dlen = dent >> 16
    return ((dent & 0xFFFF) | (int(dev[0]) << dlen)) & MASK, \
        dlen + int(deb[0])


def code_tile(arrays, b, p0, n, ll, of, rng, mutant=None):
    """(val, nb) of the tile's TL lanes (0 past n) as the kernel's threads
    leave them after coding: the staged lanes, the literals, the warp's
    matches one a lane from the gathered low words of (ml, dist), and the
    rides from their four sources."""
    sel_rows, lit_rows, data_rows, ml, dist = arrays
    val = np.zeros(TL, np.int64)
    nb = np.zeros(TL, np.int64)
    if n == 0:
        return val, nb
    sel = sel_rows.tile(b, p0, n, rng) & 1
    lit = lit_rows.tile(b, p0, n, rng) & 1
    byte = data_rows.tile(b, p0, n, rng)
    lit = lit & (1 - sel)
    if ll is None:
        hi = byte >= 144
        ln = np.where(hi, 9, 8)
        lv = bitrev(np.where(hi, 0x190 + byte - 144, 0x30 + byte), ln)
    else:
        ent = ll[byte].astype(np.int64)
        lv, ln = ent & 0xFFFF, ent >> 16
    val[:n] = np.where(lit == 1, lv, 0)
    nb[:n] = np.where(lit == 1, ln, 0)
    at = np.flatnonzero(sel)                    # the sel lanes, gathered
    gml = low_word(ml[b, p0 + at])
    gdist = low_word(dist[b, p0 + at])
    mv, mn, rv, rn = match_tokens(gml, gdist, ll, of)
    val[at], nb[at] = mv, mn
    if ll is None:
        return val, nb
    # rides into the lanes after sel lanes inside a warp (in the thread,
    # or from the thread before by the shuffle of its flags)
    inner = at[(at + 1) % WL != 0]
    ride_v = dict(zip(at.tolist(), rv.tolist()))
    ride_n = dict(zip(at.tolist(), rn.tolist()))
    for p in inner.tolist():
        if p + 1 < n:
            val[p + 1] |= ride_v[p]
            nb[p + 1] += ride_n[p]
    # a warp's first lane: the staged flag and the gathered distance of
    # the lane before it
    for w0 in range(WL, n, WL):
        if sel[w0 - 1]:
            v, c = ride_of(True, int(low_word(dist[b, p0 + w0 - 1])), of)
            val[w0] |= v
            nb[w0] += c
    # the tile's first lane: the sel flag through its aligned word and the
    # distance before the tile
    if p0 > 0 and mutant != "halo":
        v, c = ride_of(sel_rows.byte(b, p0 - 1) & 1,
                       int(low_word(dist[b, p0 - 1])), of)
        val[0] |= v
        nb[0] += c
    if mutant == "dead_ride" and n < TL and sel[n - 1]:
        # a thread past the block takes the last lane's ride
        nb[n] += ride_n[n - 1]
    return val, nb


def look_back(status, k):
    """Warp 0's look-back from tile k: 32 status words at a time, nearest
    first, summing up to and including the nearest inclusive one; None
    while a word up to it is still 0 (the warp spins)."""
    total = 0
    for j in range(k - 1, -1, -32):
        words = [status[idx] if idx >= 0 else ("inc", 0)
                 for idx in range(j, j - 32, -1)]
        first = next((i for i, w in enumerate(words)
                      if w is not None and w[0] == "inc"), 31)
        if any(w is None for w in words[:first + 1]):
            return None
        total += sum(w[1] for w in words[:first + 1])
        if words[first][0] == "inc":
            return total
    raise AssertionError("tile 0 holds an inclusive prefix")


def warp_scan(x):
    """Inclusive scan along the last axis of 32, as the shuffles give it."""
    o = 1
    while o < 32:
        x = x + np.concatenate([np.zeros_like(x[..., :o]), x[..., :-o]], -1)
        o *= 2
    return x


def tile_rows(nb):
    """A tile's row offsets from its start and its bits: each row's 4
    thread sums, then warp 0's scan of the tile's 64 row sums, 2 rows a
    lane."""
    per = nb.reshape(-1, 32).sum(1).reshape(32, 2)
    lane = per.sum(1)
    excl = warp_scan(lane) - lane
    rowoff = (excl[:, None] + np.cumsum(per, 1) - per).reshape(-1)
    return rowoff, int(lane.sum())


def pack_rows_of(val, nb, bit0, nrows, row_out):
    """A tile's rows packed as each warp does it: each thread's 8 tokens
    summed a word at a time in registers (the words a and a + 1 of its
    current word) and added into its row's frame words when it moves on,
    bits past the frame dropped; then each row's bytes as funnel shifts
    of its frame words by 8 * delta, and a zero byte. Returns (rows,
    byte_off, row_bit0) of the tile's first nrows rows."""
    nwords = row_out // 4
    v = val.reshape(TR, TPR, K)
    n = nb.reshape(TR, TPR, K)
    tsum = n.sum(-1)
    texcl = np.cumsum(tsum, 1) - tsum           # the row's shuffle scan
    rel = (bit0 & 31)[:, None] + texcl          # bits from the frame start
    words = np.zeros((TR, nwords + 2), np.int64)
    rows_i = np.repeat(np.arange(TR), TPR).reshape(TR, TPR)
    cw = np.full((TR, TPR), -1)
    a0 = np.zeros((TR, TPR), np.int64)
    a1 = np.zeros((TR, TPR), np.int64)

    def flush(w, x, m):
        ok = m & (x != 0) & (w >= 0) & (w < nwords)
        np.add.at(words, (rows_i[ok], w[ok]), x[ok])

    for e in range(K):
        w, shift = rel >> 5, rel & 31
        lo = (v[..., e] << shift) & MASK
        hi = np.where(shift == 0, 0, v[..., e] >> (32 - shift)) & MASK
        move = w != cw
        flush(cw, a0, move)
        step = move & (w == cw + 1)
        jump = move & ~step
        flush(cw + 1, a1, jump)
        a0 = np.where(step, a1, np.where(jump, 0, a0))
        a1 = np.where(move, 0, a1)
        cw = np.where(move, w, cw)
        a0 = (a0 + lo) & MASK
        a1 = (a1 + hi) & MASK
        rel = rel + n[..., e]
    flush(cw, a0, np.ones_like(move))
    flush(cw + 1, a1, np.ones_like(move))
    fw = np.concatenate([words[:, :nwords] & MASK,
                         np.zeros((TR, 1), np.int64)], 1)
    d8 = (bit0 & 24)[:, None]
    out = ((fw[:, :-1] >> d8) | np.where(d8 == 0, 0, fw[:, 1:] << (32 - d8)))
    out &= MASK
    rows = np.zeros((TR, row_out + 1), np.uint8)
    rows[:, :row_out] = ((out[..., None] >> (8 * np.arange(4))) & 0xFF) \
        .reshape(TR, row_out)
    return rows[:nrows], (bit0 >> 3)[:nrows], bit0[:nrows]


def model_emit(arrays, b, s, ll=None, of=None, start=None, seed=0, grid=3,
               mutant=None):
    """pack_rows' four outputs for b blocks of s lanes as the kernel
    builds them: `grid` persistent blocks take the tiles in ticket order;
    each codes a tile and publishes its aggregate (a block's first tile:
    its inclusive prefix), then takes the base of the tile it coded
    before by the look-back, publishes its inclusive prefix and packs it.
    A seeded scheduler interleaves the blocks' steps; a block whose
    look-back would wait gives way."""
    rng = np.random.default_rng(seed)
    dyn = ll is not None
    row_out = 64 if dyn else 48
    if not dyn:
        start = np.full(b, 3, np.int64)
    r = s // 32
    tpb = -(-r // TR)
    total = b * tpb
    status = [None] * total
    rows = np.zeros((b, r, row_out + 1), np.uint8)
    byte_off = np.zeros((b, r), np.int64)
    row_bit0 = np.zeros((b, r), np.int64)
    end_bits = np.zeros(b, np.int64)
    ticket = iter(range(total))
    coded = {}

    def code(t):
        bi, k = divmod(t, tpb)
        n = min(r - k * TR, TR) * 32
        val, nb = code_tile(arrays, bi, k * TL, n,
                            None if not dyn else ll[bi],
                            None if not dyn else of[bi], rng, mutant)
        rowoff, agg = tile_rows(nb)
        if k == 0:
            status[t] = ("inc", int(start[bi]) + agg)
        else:
            status[t] = ("agg", agg)
        coded[t] = (val, nb, rowoff, agg)

    def finish(t):
        """The look-back and the packing of a coded tile; False while the
        look-back would wait."""
        bi, k = divmod(t, tpb)
        val, nb, rowoff, agg = coded[t]
        if k == 0:
            base = int(start[bi])
        else:
            seen = [w if mutant != "agg" or w is None else ("inc", w[1])
                    for w in status[bi * tpb:bi * tpb + k]]
            if mutant == "tile":        # the look-back from the tile before
                seen = seen[:-1]
            base = look_back(seen, len(seen)) if seen else int(start[bi])
            if base is None:
                return False
            status[t] = ("inc", base + agg)
        if k == tpb - 1:
            end_bits[bi] = base + agg
        row0 = k * TR
        nrows = min(r - row0, TR)
        got = pack_rows_of(val, nb, base + rowoff, nrows, row_out)
        rows[bi, row0:row0 + nrows] = got[0]
        byte_off[bi, row0:row0 + nrows] = got[1]
        row_bit0[bi, row0:row0 + nrows] = got[2]
        del coded[t]
        return True

    # each block holds the tickets it has taken (the kernel plans its
    # steps two ahead), codes its next tile, then finishes the one it
    # coded before; a block whose look-back would wait gives way
    blocks = [{"queue": [], "pending": None, "done": False}
              for _ in range(grid)]

    def step(blk):
        """One block's next action; False if it must wait."""
        if blk["pending"] is not None and blk.get("coded_next"):
            if not finish(blk["pending"]):
                return False
            blk["pending"], blk["coded_next"] = blk["now"], False
            return True
        while len(blk["queue"]) < 3:
            t = next(ticket, None)
            if t is None:
                break
            blk["queue"].append(t)
        if not blk["queue"]:                    # the drain, then done
            if blk["pending"] is not None:
                if not finish(blk["pending"]):
                    return False
            blk["done"] = True
            return True
        blk["now"] = blk["queue"].pop(0)
        code(blk["now"])
        if blk["pending"] is None:
            blk["pending"] = blk["now"]
        else:
            blk["coded_next"] = True
        return True

    while not all(x["done"] for x in blocks):
        order = [x for x in blocks if not x["done"]]
        rng.shuffle(order)
        assert any(step(x) for x in order), "every block waits: a deadlock"
    return rows, byte_off, row_bit0, end_bits


def byte_rows(data, ml, dist, sel, lit, s, layout=None):
    """The model's arrays: the byte arrays as Rows (as they are, or at the
    layout's (first, extra) columns of wider rows, data first), ml and
    dist as they are."""
    layout = layout or ((0, 0),) * 5
    return (Rows(sel.astype(np.uint8), s, *layout[3], seed=1),
            Rows(lit.astype(np.uint8), s, *layout[4], seed=2),
            Rows(np.asarray(data), s, *layout[0], seed=3), ml, dist)


def overflowing(b, s, seed):
    """test_torch_encode_l6's random (val, nb): bit counts up to 28, so
    rows overflow their frames; block 0's first row all 28-bit tokens."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 29, (b, s))
    nb[0, :32] = 28
    val = rng.integers(0, 1 << 31, (b, s)) & ((1 << nb) - 1)
    return val.astype(np.int64), nb.astype(np.int64)


@pytest.mark.parametrize("width", ["row", "tile", "tiles"])
@pytest.mark.parametrize("row_out", [48, 64])
def test_model_packs_overflowing_rows_as_pack_rows(row_out, width):
    """The model's packing (the tokens of a word summed in registers, the
    funnel shifts) equals the plain pack_rows on random rows that
    overflow their frames, at start bits 0, 3, 31 and 77, on one row, one
    tile and several tiles with a part."""
    width = {"row": 32, "tile": TL, "tiles": 3 * TL + 96}[width]
    val, nb = overflowing(4, width, seed=width + row_out)
    start = np.array([0, 3, 31, 77], np.int64)
    assert nb[0, :32].sum() > 8 * row_out       # a row past its frame
    want = pev.pack_rows(*tensors(val, nb, start), row_out)
    r = width // 32
    for bi in range(4):
        v = np.pad(val[bi], (0, -width % TL))
        n = np.pad(nb[bi], (0, -width % TL))
        bit = start[bi] + np.concatenate([[0], np.cumsum(n)[:-1]])
        for tile in range(-(-r // TR)):
            sl = slice(tile * TL, (tile + 1) * TL)
            nrows = min(r - tile * TR, TR)
            got = pack_rows_of(v[sl], n[sl], bit[sl][::32], nrows, row_out)
            rs = slice(tile * TR, tile * TR + nrows)
            for g, w in zip(got, want[:3], strict=True):
                eq(g, w[bi, rs].numpy())


@pytest.mark.parametrize("grid", [1, 2, 4, 8])
def test_model_chunk_bases_under_any_schedule(grid):
    """The pipelined look-back gives every chunk of the block (a tile)
    its base whichever way the blocks' steps interleave (three seeded
    schedules of `grid` persistent blocks), with no deadlock: 70 tiles
    (the look-back past two rounds of 32 status words), random
    overflowing tokens, dynamic mode."""
    rng = np.random.default_rng(grid)
    s = 70 * TL
    sel = rng.random((1, s)) < 0.3
    lit = rng.random((1, s)) < 0.6
    ml = rng.integers(0, 259, (1, s))
    dist = rng.integers(0, 32769, (1, s))
    data = rng.integers(0, 256, (1, s), dtype=np.uint8)
    ll = (rng.integers(0, 1 << 16, (1, 288)) | (rng.integers(0, 16, (1, 288))
                                                << 16)).astype(np.int32)
    of = (rng.integers(0, 1 << 16, (1, 30)) | (rng.integers(0, 16, (1, 30))
                                               << 16)).astype(np.int32)
    start = np.array([12345], np.int64)
    want = em.emit(*tensors(data, ml, dist, sel, lit), s,
                   *tensors(ll, of, start))
    arrays = byte_rows(data, ml, dist, sel, lit, s)
    for seed in range(3):
        got = model_emit(arrays, 1, s, ll, of, start, seed, grid)
        for g, w in zip(got, want, strict=True):
            eq(w, g)


def test_model_reads_rows_at_every_offset():
    """The staged reads equal the rows' lanes at every row start mod 16,
    for a tile's lanes, a short tile and a row of 32, whether the copy
    rounds out or takes the aligned middle (then the first and last lanes
    come from memory), and the lane before a tile through its word."""
    rng = np.random.default_rng(7)
    for first in range(16):
        for n in (32, 96, TL):
            x = rng.integers(0, 256, (3, n + 40), dtype=np.uint8)
            for extra in (0, 16):
                rows = Rows(x, n + 40, first, extra, seed=first)
                assert rows.round == (extra > 0 or (first + n + 40) % 16
                                      == 0)
                for bi in range(3):
                    for p0, m in ((0, n), (8, n - 8), (40, n)):
                        eq(rows.tile(bi, p0, m, rng), x[bi, p0:p0 + m])
                    assert rows.byte(bi, n - 1) == x[bi, n - 1]


@pytest.mark.parametrize("make", [emit_cases, emit_random_cases,
                                  emit_chunk_cases])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_model_emits_the_arrays_as_the_plain_version(mode, make):
    """The model equals the plain version on the trap arrays (matches on a
    row's, a warp's, a tile's and the block's last lane, the tile-edge
    traps of emit_chunk_cases), random inputs whose rows overflow in both
    modes, its blocks' steps interleaved by seeded schedulers of 1, 3, 7
    and 16 blocks."""
    _, data, ml, dist, sel, lit, ll, of, start = make()
    b, s = ml.shape
    tables = (ll, of, start) if mode == "dynamic" else ()
    want = em.emit(*tensors(data, ml, dist, sel, lit), s, *tensors(*tables))
    arrays = byte_rows(data, ml, dist, sel, lit, s)
    for seed, grid in ((1, 1), (2, 3), (4, 7), (8, 16)):
        got = model_emit(arrays, b, s, *tables, seed=seed, grid=grid)
        for g, w in zip(got, want, strict=True):
            eq(w, g)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_model_emits_unaligned_rows_as_the_plain_version(mode):
    """The tile-edge traps through the rows of tests/_port_corpus's
    emit_unaligned (every array's rows off 16 bytes, column views of wider
    rows, as the flows hand some over), under schedules of 2 and 4
    blocks, the copies rounded out where the storage allows and again
    their aligned middles only (a tensor that ends with its last row)."""
    _, data, ml, dist, sel, lit, ll, of, start = emit_chunk_cases()
    b, s = ml.shape
    tables = (ll, of, start) if mode == "dynamic" else ()
    want = em.emit(*tensors(data, ml, dist, sel, lit), s, *tensors(*tables))
    arrays = byte_rows(data, ml, dist, sel, lit, s, EMIT_UNALIGNED)
    rounds = [x.round for x in arrays[:3]]
    assert any(rounds)
    for grid in (2, 4):
        for exact in (False, True):      # the copies' aligned middles only
            for x, rnd in zip(arrays[:3], rounds):
                x.round = rnd and not exact
            got = model_emit(arrays, b, s, *tables, seed=grid + 10,
                             grid=grid)
            for g, w in zip(got, want, strict=True):
                eq(w, g)


@pytest.mark.parametrize("tier", ["l6", "l4"])
@pytest.mark.parametrize("kind", KINDS)
def test_model_emits_the_flows_as_the_plain_version(kind, tier, flows):
    """The model on the L6 and L4 tiers' emit inputs (the JAX package's,
    which the port's analyze equals; the L6 bytes as the payload columns
    of the windows' rows) and on the L1 tier's tokens (the L1-5 rows of
    block + 266 bytes)."""
    data, ml, dist, sel, lit, ll, of, hb = flows[kind][tier]
    args = (data, ml.astype(np.int64), dist.astype(np.int64), sel, lit)
    want = port_dynamic(*args, ll, of, hb, BLOCK)
    b = ml.shape[0]
    # the L6 bytes: the payload columns of the windows' rows
    layout = ((ped.HIST if tier == "l6" else 0, 0),) + ((0, 0),) * 4
    arrays = byte_rows(*args, BLOCK, layout)
    got = model_emit(arrays, b, BLOCK, ll, of, hb.astype(np.int64), 5)
    for g, w in zip(got, want, strict=True):
        eq(w, g)
    (arr, ml, dist, sel, lit), _ = flows[kind]["l1"]
    args = (arr, ml.astype(np.int64), dist.astype(np.int64), sel, lit)
    want = em.emit(*tensors(*args), BLOCK)
    for g, w in zip(model_emit(byte_rows(*args, BLOCK), b, BLOCK, seed=6,
                               grid=2), want, strict=True):
        eq(w, g)


@pytest.mark.parametrize("mutant", ["tile", "halo", "dead_ride", "agg"])
def test_mutated_models_fail(mutant):
    """Each mutated model disagrees with the plain version on the tile-edge
    traps (dynamic mode): a look-back that starts a tile too early (a
    tile's base off by one tile), no ride into a tile's first lane, a
    thread past the block's last row taking the last lane's ride, a
    look-back that stops at an aggregate."""
    _, data, ml, dist, sel, lit, ll, of, start = emit_chunk_cases()
    b, s = ml.shape
    if mutant == "dead_ride":       # a match on the block's last lane
        sel[:, s - 1], lit[:, s - 1] = True, False
    want = em.emit(*tensors(data, ml, dist, sel, lit), s,
                   *tensors(ll, of, start))
    arrays = byte_rows(data, ml, dist, sel, lit, s)
    got = model_emit(arrays, b, s, ll, of, start, seed=3, grid=4,
                     mutant=mutant)
    assert not all(np.array_equal(np.asarray(g), w.numpy())
                   for g, w in zip(got, want))
    good = model_emit(arrays, b, s, ll, of, start, seed=3, grid=4)
    for g, w in zip(good, want, strict=True):
        eq(w, g)
