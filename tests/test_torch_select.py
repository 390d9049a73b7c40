"""Token selection: a numpy model of the CUDA kernel's decomposition
(`csrc/select.cu`) and `ops/select.select` on CPU tensors (its plain
version, `select_plain`) against the JAX package, on the L6 trap windows
of `tests/_port_corpus.l6_windows`, the seeded edge arrays of
`tests/_port_corpus.select_cases` and the tile-edge arrays of its
`select_tile_cases`. Tolerance: exact equality (integers).

The kernel reads only the payload [start, s) and halos around it (at L6
start is HIST: the history mask zeroes ml below it, so the run boundary
at start is set). It takes every tile of a window at once, each from
(ml, dist) on [T - 512, T + tile + 256) alone: run extension over that
range, the chain cut at its end (a chain member has ml >= 4, so a chain
that reaches 254 positions on reaches the 258 cap), the lazy demotion,
the run starts, and the raw and selected ends' prefix maxima from the
range's start (a long match reaches at most 256 on, so sel1 is exact
from T - 256 and covered from T on). Only the run start is carried: each
tile publishes X, its last boundary at or before T + tile - 513, or
NONE when its own range shows none there; a tile with no boundary at
T - 512 .. T - 510 takes the run start from the nearest earlier tile
whose word holds an X. Phase 2 is per cell: the next sel1 and the next
candidate by lane, a jump table from each candidate to the first
candidate past its span, the walk along it to the cell's end (no step
bound: each selection advances at least MIN_MATCH, so the walk ends
within the JAX package's W // 4 + 1 steps), and the lanes stepped over
as those outside every selected span; the histograms are counted per
tile and summed. The model repeats that, with the tile as a parameter;
the kernel itself runs only on a card (`tests/test_torch_cuda.py` holds
it to the plain version there).

One window width per bucket: the trap windows' 16 KiB blocks, the edge
arrays' 8 KiB payload behind the 32 KiB history and the tile-edge
arrays' four tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import (SELECT_TILE, l6_windows, select_cases,
                          select_tile_cases)
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu.ops import static_codes as jsc
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import select as psel

torch.set_num_threads(2)
HIST = 32768
NEG = -(1 << 20)
NOB = -(1 << 30)                  # no run boundary yet
TILE = SELECT_TILE
LEFT, RIGHT = 512, 256           # a tile's halos
LABELS, ROWS, VALID, HIST_START, S = l6_windows()
E_LABELS, E_ML, E_DIST, E_VALID, E_DATA = select_cases()
LABELS_AT = {label: i for i, label in enumerate(E_LABELS)}
# the tile-edge arrays, with their edges at the flags' tile edges
T_CASES = {start: select_tile_cases(start) for start in (HIST, 0)}
T_LABELS = T_CASES[HIST][0]
# (name, start, cell width, lazy, histograms): the three callers' flags
FLAGS = {"l6": (HIST, 256, True, True), "dynamic": (0, 64, False, True),
         "static": (0, 64, False, False)}


# ------------------------------------------- numpy model of the kernel
def length_sym(n):
    """The kernel's closed form of the DEFLATE length symbol (4..258)."""
    n = np.asarray(n, np.int64)
    x = n - 3
    eb = np.maximum(np.floor(np.log2(np.maximum(x, 1))).astype(np.int64)
                    - 2, 1)
    sym = np.where(x < 8, 257 + x, 257 + (eb << 2) + (x >> eb))
    return np.where(n == 258, 285, sym)


def offset_sym(d):
    """The kernel's closed form of the DEFLATE offset symbol (1..32768)."""
    o = np.asarray(d, np.int64) - 1
    b = np.floor(np.log2(np.maximum(o, 1))).astype(np.int64)
    return np.where(o < 4, o, 2 * b + ((o >> np.maximum(b - 1, 0)) & 1))


def seg_suffix_max(v, c):
    """r[i] = the max of v over i's chain (i, i + 1, ... while c holds;
    c[-1] is taken as false: the chain ends at the range's end)."""
    g = np.concatenate([[0], np.cumsum(~c[:-1])])   # chain ids
    off = (g[-1] - g) << 22                          # > the range of v
    return np.maximum.accumulate((v + off)[::-1])[::-1] - off


def _cells(dm, mt, sel1, covered, p, valid, W):
    """Phase 2 over one tile's positions p (whole cells): ml_short, the
    candidates, the walk of every cell by its jump table, the selected
    spans' union for the lanes stepped over. Returns (ml_short, sel2,
    lit)."""
    n = len(p)
    lane = np.arange(n) % W
    # the next sel1 after each lane, and the first candidate at or after
    # it, within the cell (the cell's end where there is none)
    nxt1 = np.empty(n, np.int64)
    nc = np.empty(n, np.int64)
    for cb in range(0, n, W):
        c = slice(cb, cb + W)
        ones = np.flatnonzero(sel1[c])
        k = np.searchsorted(ones, np.arange(W), "right")
        nxt1[c] = np.append(ones, W)[k]
    ml_short = np.minimum(np.minimum(dm, W - lane), nxt1 - lane)
    cand = mt & ~sel1 & ~covered & (ml_short >= 4)
    for cb in range(0, n, W):
        c = slice(cb, cb + W)
        ones = np.flatnonzero(cand[c])
        nc[c] = np.append(ones, W)[np.searchsorted(ones, np.arange(W))]
    # jmp[c]: the first candidate at or past the end of c's span
    sel2 = np.zeros(n, bool)
    end = np.zeros(n, np.int64)
    for cb in range(0, n, W):
        tgt = np.arange(W) + ml_short[cb:cb + W]
        jmp = np.where(tgt < W, nc[cb:cb + W][np.minimum(tgt, W - 1)], W)
        x = nc[cb]
        while x < W:
            sel2[cb + x] = True
            end[cb + x] = x + ml_short[cb + x]
            x = jmp[x]
    # a lane is stepped over unless a selected span [c, c + ml_short)
    # holds it
    span = np.zeros(n, np.int64)
    for cb in range(0, n, W):
        span[cb:cb + W] = np.maximum.accumulate(end[cb:cb + W])
    vis = span <= lane
    lit = vis & (p < valid) & ~covered & ~sel1 & ~sel2
    return ml_short, sel2, lit


def kernel_model(ml, dist, valid, data, start, W, lazy, hist, tile=TILE):
    """(ml_emit, sel, lit[, ll_hist, of_hist]) of one window over
    [start, s), as csrc/select.cu computes them: every tile alone over
    its halos [T - 512, T + tile + 256), the run start carried by the
    tiles' status words, the histograms summed over the tiles."""
    ml = np.asarray(ml, np.int64)
    dist = np.asarray(dist, np.int64)
    s = len(ml)
    n = s - start
    ml_emit = np.zeros(n, np.int64)
    sel = np.zeros(n, bool)
    lit = np.zeros(n, bool)
    ll = np.zeros(288, np.int64)
    of = np.zeros(30, np.int64)
    agg, inc = [], []                    # each tile's status word
    for k, T in enumerate(range(start, s, tile)):
        # positions lo - 1 .. hi; what lies outside [start, s) (or past
        # the range, at hi) reads as unmatched
        lo, hi = T - LEFT, T + tile + RIGHT
        q = np.arange(lo - 1, hi + 1)
        inside = (q >= start) & (q < s) & (q < hi)
        m = np.where(inside, ml[np.clip(q, 0, s - 1)], 0)
        m = np.where(m >= 4, np.minimum(m, 258), 0)
        d = np.where((q >= 0) & (q < s), dist[np.clip(q, 0, s - 1)], 0)
        # run extension over the range, the chain cut at its end
        matched = m >= 4
        eq = (q[:-1] + 1 < s) & (d[1:] == d[:-1])
        c = matched[:-1] & matched[1:] & eq
        r = seg_suffix_max(np.where(matched[:-1], m[:-1] + q[:-1], NEG), c)
        ext = np.where(matched[:-1], np.maximum(0, np.minimum(
            np.minimum(r - q[:-1], 258), valid - q[:-1])), 0)
        # lazy demotion and the matched lanes, lo - 1 .. hi - 2 (the
        # last position's ext needs hi, which reads as unmatched)
        e, e1 = ext[:-1], ext[1:]
        dm = e.copy()
        if lazy:
            dm[(e1 > e) & (e >= 4) & (e1 >= 4)] = 0
        p = q[:-2]
        mt = (dm >= 4) & (p < valid) & (p >= start)
        # run starts over [lo, hi - 1)
        boundary = ~(mt[1:] & mt[:-1] & eq[:len(mt) - 1])
        p, dm, mt = p[1:], dm[1:], mt[1:]
        local = np.maximum.accumulate(np.where(boundary, p, NOB))
        at = T + tile - 513 - lo         # the status word's position
        agg.append(local[at] if local[at] != NOB else None)
        carry = -1
        if local[2] == NOB:              # no boundary at <= T - 510
            j = k - 1
            while agg[j] is None:
                j -= 1
            carry = agg[j]
            assert carry == inc[k - 1]
        rs = np.where(local != NOB, local, carry)
        inc.append(rs[at])
        # the two prefix maxima, from the range's start
        ml_run = np.minimum(dm, 256 - ((p - rs) & 255))
        long_ok = mt & (ml_run >= 32)
        raw = np.where(long_ok, p + ml_run, 0)
        raw_ex = np.concatenate([[0], np.maximum.accumulate(raw)[:-1]])
        sel1 = long_ok & (raw_ex <= p)
        ends = np.where(sel1, p + ml_run, 0)
        covered = np.concatenate([[0], np.maximum.accumulate(ends)[:-1]]) > p
        # phase 2 and the outputs over the tile's positions
        t = slice(LEFT, LEFT + min(tile, s - T))
        ml_short, sel2, lt = _cells(dm[t], mt[t], sel1[t], covered[t], p[t],
                                    valid, W)
        o = slice(T - start, T - start + len(ml_short))
        sel[o] = sel1[t] | sel2
        lit[o] = lt
        ml_emit[o] = np.where(sel1[t], ml_run[t], ml_short)
        if hist:
            pt = p[t]
            ll += np.bincount(np.concatenate([
                length_sym(np.maximum(ml_emit[o][sel[o]], 4)),
                np.asarray(data[pt[lt]], np.int64)]), minlength=288)
            of += np.bincount(offset_sym(np.clip(dist[pt[sel[o]]], 1,
                                                 32768)), minlength=30)
    if not hist:
        return ml_emit, sel, lit
    return (ml_emit, sel, lit, np.minimum(ll, 65535),
            np.minimum(of, 65535))


# ---------------------------------------------- the JAX package's side
def _jax_select(ml, dist, valid, data, start, W, lazy, hist):
    """extend_runs, the L6 history mask and lazy demotion as
    analyze_block_l6 runs them, select_tokens and the histograms (as
    analyze_block and analyze_block_l6 take them), under jit(vmap)."""
    s = ml.shape[1]

    def one(m, d, v, row):
        m = jev.extend_runs(m, d, v)
        if lazy:
            posv = jnp.arange(s, dtype=jnp.int32)
            m = jnp.where(posv >= start, m, 0)
            nxt = jnp.concatenate([m[1:], jnp.zeros(1, jnp.int32)])
            m = jnp.where((nxt > m) & (m >= 4) & (nxt >= 4), 0, m)
        m, sel, lit = jev.select_tokens(m, d, v, wtile=W)
        m, d, sel, lit = m[start:], d[start:], sel[start:], lit[start:]
        if not hist:
            return m, sel, lit
        lsym, _, _ = jsc.length_sym_fields(jnp.maximum(m, 4))
        dsym, _, _ = jsc.offset_sym_fields(jnp.clip(d, 1, 32768))
        hsym = jnp.where(sel, lsym, jnp.where(lit, row[start:s].astype(
            jnp.int32), jed._NOSYM_LL))
        return (m, sel, lit,
                jnp.minimum(jed._hist(hsym, 288), 65535).astype(jnp.uint16),
                jnp.minimum(jed._hist(jnp.where(sel, dsym, jed._NOSYM_OF),
                                      30), 65535).astype(jnp.uint16))

    out = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (
        ml.astype(np.int32), dist.astype(np.int32), valid, data)))
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def traps():
    """The trap windows: the match finder's (ml, dist) (the port's plain
    version, held to the JAX function in tests/test_torch_match_l6.py)
    and the JAX package's jit_analyze_l6 outputs."""
    ml, dist = ped.find_matches_l6_plain(
        torch.from_numpy(ROWS), torch.from_numpy(VALID),
        torch.from_numpy(HIST_START), S)
    want = jed.jit_analyze_l6(S - HIST)(
        jnp.asarray(ROWS), jnp.asarray(VALID), jnp.asarray(HIST_START))
    return ml.numpy(), dist.numpy(), [np.asarray(w) for w in want]


@pytest.fixture(scope="module")
def edge_want():
    """The JAX package's outputs on the edge arrays, per caller's flags."""
    return {name: _jax_select(E_ML, E_DIST, E_VALID, E_DATA, *flags)
            for name, flags in FLAGS.items()}


@pytest.fixture(scope="module")
def tile_want():
    """The JAX package's outputs on the tile-edge arrays, per caller's
    flags, and its extend_runs on them."""
    want = {}
    for name, flags in FLAGS.items():
        _, ml, dist, valid, data = T_CASES[flags[0]]
        want[name] = _jax_select(ml, dist, valid, data, *flags)
    for start, (_, ml, dist, valid, _) in T_CASES.items():
        want[start] = np.asarray(jax.jit(jax.vmap(jev.extend_runs))(
            jnp.asarray(ml.astype(np.int32)),
            jnp.asarray(dist.astype(np.int32)), jnp.asarray(valid)))
    return want


def _eq(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w)
        assert np.array_equal(g.astype(np.int64), np.asarray(w, np.int64))


# ------------------------------------------------------------------ tests
def test_model_symbols_exhaustive():
    """The model's closed-form symbols are the JAX package's, for every
    length 4..258 and distance 1..32,768."""
    lens = np.arange(4, 259)
    dists = np.arange(1, 32769)
    assert np.array_equal(length_sym(lens), np.asarray(
        jsc.length_sym_fields(jnp.asarray(lens, jnp.int32))[0]))
    assert np.array_equal(offset_sym(dists), np.asarray(
        jsc.offset_sym_fields(jnp.asarray(dists, jnp.int32))[0]))


@pytest.mark.parametrize("row", range(len(LABELS)), ids=LABELS)
def test_model_equals_jax_analyze_l6_on_trap_windows(row, traps):
    ml, dist, want = traps
    got = kernel_model(ml[row], dist[row], VALID[row], ROWS[row],
                       *FLAGS["l6"])
    _eq(got, [want[0][row], want[2][row], want[3][row], want[4][row],
              want[5][row]])
    assert np.array_equal(dist[row, HIST:], want[1][row])


@pytest.mark.parametrize("tile", [TILE, 512])
@pytest.mark.parametrize("name", list(FLAGS))
@pytest.mark.parametrize("row", range(len(E_LABELS)), ids=E_LABELS)
def test_model_equals_jax_on_edge_arrays(row, name, tile, edge_want):
    """The seeded edge arrays at each caller's flags, with the kernel's
    tile and with a small one (more carries across tile edges)."""
    got = kernel_model(E_ML[row], E_DIST[row], E_VALID[row], E_DATA[row],
                       *FLAGS[name], tile=tile)
    _eq(got, [w[row] for w in edge_want[name]])


def test_edge_arrays_reach_their_traps(edge_want):
    """The edge arrays hit what they are named for: a cell of 64 selected
    four-byte matches (and 16 in each 64-position cell), long matches of
    31-33 selected, and selections on both sides of a tile edge."""
    ml, sel, _, _, _ = edge_want["l6"]
    cell = LABELS_AT["a cell of 64 four-byte matches"]
    at = 4096 + 512
    assert sel[cell, at:at + 256].sum() == 64
    assert (ml[cell, at:at + 256][sel[cell, at:at + 256]] == 4).all()
    dsel = edge_want["dynamic"][1][cell, HIST + at:HIST + at + 64]
    assert dsel.sum() == 16
    lengths = LABELS_AT["lengths 31, 32 and 33"]
    long = ml[lengths][sel[lengths]]
    assert {31, 32, 33} <= set(long.tolist())
    edge = LABELS_AT["chains across tile and cell edges"]
    assert sel[edge, 4096 - 64:4096].any() and sel[edge, 4096:4096 + 64].any()
    assert not sel[LABELS_AT["valid_len below HIST"]].any()



@pytest.mark.parametrize("tile", [TILE, 512])
@pytest.mark.parametrize("name", list(FLAGS))
@pytest.mark.parametrize("row", range(len(T_LABELS)), ids=T_LABELS)
def test_model_equals_jax_on_tile_edge_arrays(row, name, tile, tile_want):
    """The tile-edge arrays at each caller's flags, with the kernel's tile
    (whose edges they sit at) and with a small one."""
    _, ml, dist, valid, data = T_CASES[FLAGS[name][0]]
    got = kernel_model(ml[row], dist[row], valid[row], data[row],
                       *FLAGS[name], tile=tile)
    _eq(got, [w[row] for w in tile_want[name]])


def _phase1(ext, dist, valid, start, lazy):
    """Phase 1 over a whole window, untiled, from run extension's output
    (for the traps): (rs, long_ok, raw ends' exclusive max, sel1,
    covered)."""
    s = len(ext)
    p = np.arange(s)
    m = np.where(p >= start, ext, 0)
    if lazy:
        nxt = np.append(m[1:], 0)
        m = np.where((nxt > m) & (m >= 4) & (nxt >= 4), 0, m)
    mt = (m >= 4) & (p < valid)
    boundary = ~(mt & np.append(False, mt[:-1])
                 & (dist == np.append(0, dist[:-1])))
    rs = np.maximum.accumulate(np.where(boundary, p, -1))
    ml_run = np.minimum(m, 256 - ((p - rs) % 256))
    long_ok = mt & (ml_run >= 32)
    raw = np.where(long_ok, p + ml_run, 0)
    raw_ex = np.append(0, np.maximum.accumulate(raw)[:-1])
    sel1 = long_ok & (raw_ex <= p)
    ends = np.where(sel1, p + ml_run, 0)
    covered = np.append(0, np.maximum.accumulate(ends)[:-1]) > p
    return rs, long_ok, raw_ex, sel1, covered


@pytest.mark.parametrize("start", [HIST, 0])
def test_tile_edge_arrays_reach_their_traps(start, tile_want):
    """Each tile-edge array hits what it is named for, at the edges E1-E3
    of the tiles from `start` (at the L6 flags for HIST, the dynamic
    flags for 0)."""
    l6 = start == HIST
    _, ml_in, dist, valid, _ = T_CASES[start]
    ext = tile_want[start]
    sel = tile_want["l6" if l6 else "dynamic"][1]
    at = {label: i for i, label in enumerate(T_LABELS)}
    e1, e2, e3 = (start + k * TILE for k in (1, 2, 3))

    def phase1(r):
        return _phase1(ext[r], dist[r], valid[r], start, l6)

    def sel_at(r, p):
        return bool(sel[r, p - start])

    # a chain capped all along before E1; capped and short of the cap
    # before E2, reaching over it; lengths of 4 capped at E3 - 1
    r = at["chains across a tile edge at the 258 cap"]
    assert (ext[r, e1 - 40:e1] == 258).all()
    assert ext[r, e2 - 150] == 258 and ext[r, e2 - 1] == 154
    assert ml_in[r, e3 - 1] == 4 and ext[r, e3 - 1] == 258
    # ext[E] = 258 only through the member at E + 254; at L6 it demotes
    # E - 1 (257)
    r = at["ext at a tile edge from the right halo's end"]
    for e in (e1, e2, e3):
        assert ext[r, e] == 258 and ext[r, e - 1] == 257
        assert ml_in[r, e + 254] == 4 and ml_in[r, e + 255] == 0
        if l6:
            assert not sel_at(r, e - 1) and sel_at(r, e)
    # run starts carried across tile edges: over all of tile 1 into
    # tile 2, and up to runs ending at and around E and E - 512
    for label, runs in (
            ("a run over a whole tile", [(e1 - 1000, e2 + 503)]),
            ("runs ending at E - 1, E and E - 512",
             [(e1 - 1600, e1 - 1), (e2 - 1600, e2), (e3 - 1600, e3 - 512)]),
            ("runs ending at E - 513, E - 511 and E - 2",
             [(e1 - 1600, e1 - 513), (e2 - 1600, e2 - 511),
              (e3 - 1600, e3 - 2)])):
        r = at[label]
        rs, _, _, sel1, _ = phase1(r)
        for first, last in runs:
            assert (rs[first:last + 1] == first).all() and rs[last + 1] > last
            grid = np.arange(first, last - 31, 256)
            assert len(grid) >= 2 and sel1[grid].all()
    r = at["a run over a whole tile"]
    assert (phase1(r)[0][e1 - 512:e2 + 504] == e1 - 1000).all()
    # the staircase of raw ends crossing E1; a selected match covering
    # E2; at E3 the raw end of E3 - 510 keeps E3 - 255 unselected, so E3
    # is not covered, and its match is selected
    r = at["long matches whose ends cross a tile edge"]
    _, long_ok, raw_ex, sel1, covered = phase1(r)
    assert sel1[e1 - 500] and sel1[e1 + 61] and raw_ex[e1] > e1
    for o in (-240, -55, 20):
        assert long_ok[e1 + o] and not sel1[e1 + o]
        assert raw_ex[e1 + o] == max(p + ext[r, p] for p in (
            e1 - 500, e1 - 260, e1 - 240, e1 - 55) if p < e1 + o)
    assert sel1[e2 - 100] and covered[e2:e2 + 100].all()
    assert sel1[e3 - 510] and long_ok[e3 - 255] and not sel1[e3 - 255]
    assert raw_ex[e3 - 255] == e3 - 254 and not covered[e3]
    assert sel_at(r, e3)
    # valid_len 100 positions into the right halo of the tile before E1
    r = at["valid_len inside a right halo"]
    assert valid[r] == e1 + 100 and ext[r, e1 - 1] == 101
    assert not any(sel_at(r, p) for p in range(e1 + 100, e1 + 300))
    # the lazy rule's pairs across E, E - 512 | E - 513 and E + 256
    r = at["lazy-demotion pairs across a tile edge"]
    for e in (e1, e2, e3):
        for p in (e - 1, e - 513, e + 255):
            assert ext[r, p] == 5 and ext[r, p + 1] == 9
            if l6:
                assert not sel_at(r, p) and sel_at(r, p + 1)


def test_model_saturates_histograms():
    """A 65,536-position payload of one literal byte: its bin saturates
    at 65,535, as the JAX package's does."""
    s = HIST + 65536
    ml = np.zeros((1, s), np.int64)
    dist = np.zeros((1, s), np.int64)
    data = np.full((1, s + 266), 7, np.uint8)
    valid = np.array([s], np.int32)
    want = _jax_select(ml, dist, valid, data, *FLAGS["l6"])
    assert want[3][0, 7] == 65535
    _eq(kernel_model(ml[0], dist[0], valid[0], data[0], *FLAGS["l6"]),
        [w[0] for w in want])


@pytest.mark.parametrize("name", list(FLAGS))
def test_select_entry_on_cpu_equals_jax_on_edge_arrays(name, edge_want):
    """ops/select.select on CPU tensors, at each caller's flags."""
    start, _, l6, hist = FLAGS[name]
    ml, dist = torch.from_numpy(E_ML), torch.from_numpy(E_DIST)
    got = psel.select(ml, dist, torch.from_numpy(E_VALID),
                      torch.from_numpy(E_DATA) if hist else None, l6=l6)
    assert len(got) == (6 if hist else 4)
    assert got[0].dtype == torch.int64 and got[2].dtype == torch.bool
    assert got[1].data_ptr() == dist[:, start:].data_ptr()
    want = edge_want[name]
    _eq([got[0], got[2], got[3]] + list(got[4:]), want)
    if hist:
        assert got[4].dtype == got[5].dtype == torch.uint16


@pytest.mark.parametrize("name", list(FLAGS))
def test_select_entry_on_cpu_equals_jax_on_tile_edge_arrays(name,
                                                            tile_want):
    """ops/select.select on CPU tensors on the tile-edge arrays."""
    _, ml, dist, valid, data = T_CASES[FLAGS[name][0]]
    got = psel.select(torch.from_numpy(ml), torch.from_numpy(dist),
                      torch.from_numpy(valid),
                      torch.from_numpy(data) if FLAGS[name][3] else None,
                      l6=FLAGS[name][2])
    _eq([got[0], got[2], got[3]] + list(got[4:]), tile_want[name])


def test_select_entry_on_cpu_equals_jax_analyze_l6(traps):
    ml, dist, want = traps
    got = psel.select(torch.from_numpy(ml), torch.from_numpy(dist),
                      torch.from_numpy(VALID), torch.from_numpy(ROWS),
                      l6=True)
    _eq(got, want)
