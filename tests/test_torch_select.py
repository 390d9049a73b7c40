"""Token selection: a numpy model of the CUDA kernel's decomposition
(`csrc/select.cu`) and `ops/select.select` on CPU tensors (its plain
version, `select_plain`) against the JAX package, on the L6 trap windows
of `tests/_port_corpus.l6_windows` and on the seeded edge arrays of
`tests/_port_corpus.select_cases`. Tolerance: exact equality (integers).

The kernel reads only the payload [start, s) (at L6 start is HIST: the
history mask zeroes ml below it, so the run boundary at start is set and
both prefix maxima start at 0 there, and run extension at t >= start
reads only forward). It walks tiles of 4,096 positions: backward for run
extension (a segmented suffix max carried into the tile before),
forward for the lazy demotion (a one-position halo), the three prefix
maxima of phase 1 (carried), and phase 2, where one thread walks each
cell candidate to candidate to its end (no step bound: each selection
advances at least MIN_MATCH, so the walk ends within the JAX package's
W // 4 + 1 steps); the histograms are counted. The model repeats that,
with the tile as a parameter; the kernel itself runs only on a card
(`tests/test_torch_cuda.py` holds it to the plain version there).

One window width per bucket: the trap windows' 16 KiB blocks, and the
edge arrays' 8 KiB payload behind the 32 KiB history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import l6_windows, select_cases
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu.ops import static_codes as jsc
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import select as psel

torch.set_num_threads(2)
HIST = 32768
NEG = -(1 << 20)
TILE = 4096
LABELS, ROWS, VALID, HIST_START, S = l6_windows()
E_LABELS, E_ML, E_DIST, E_VALID, E_DATA = select_cases()
LABELS_AT = {label: i for i, label in enumerate(E_LABELS)}
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


def seg_suffix_max(v, c, after):
    """r[i] = the max of v over i's chain (i, i + 1, ... while c holds),
    and `after` where the chain runs past the tile's end."""
    g = np.concatenate([[0], np.cumsum(~c[:-1])])   # chain ids
    off = (g[-1] - g) << 22                          # > the range of v
    r = np.maximum.accumulate((v + off)[::-1])[::-1] - off
    if c[-1]:
        r = np.where(g == g[-1], np.maximum(r, after), r)
    return r


def kernel_model(ml, dist, valid, data, start, W, lazy, hist, tile=TILE):
    """(ml_emit, sel, lit[, ll_hist, of_hist]) of one window over
    [start, s), as csrc/select.cu computes them."""
    ml = np.asarray(ml, np.int64)
    dist = np.asarray(dist, np.int64)
    s = len(ml)
    n = s - start
    tiles = [(lo, min(lo + tile, s)) for lo in range(start, s, tile)]
    # pass 1, backward: ext and dist[p] == dist[p + 1]
    ext = np.zeros(n, np.int64)
    eq = np.zeros(n, bool)
    after = NEG
    for lo, hi in reversed(tiles):
        p = np.arange(lo, hi)
        m, d = ml[lo:hi], dist[lo:hi]
        nm = np.append(ml[lo + 1:hi + 1], 0)[:hi - lo]
        nd = np.append(dist[lo + 1:hi + 1], 0)[:hi - lo]
        e = (p + 1 < s) & (nd == d)
        matched = m >= 4
        r = seg_suffix_max(np.where(matched, m + p, NEG),
                           matched & (nm >= 4) & e, after)
        ext[lo - start:hi - start] = np.where(
            matched, np.maximum(0, np.minimum(np.minimum(r - p, 258),
                                              valid - p)), 0)
        eq[lo - start:hi - start] = e
        after = r[0]
    # pass 2, forward, with carries
    ml_emit = np.zeros(n, np.int64)
    sel = np.zeros(n, bool)
    lit = np.zeros(n, bool)
    rs_c, raw_c, selm_c = start, 0, 0
    for lo, hi in tiles:
        p = np.arange(lo, hi)
        j = p - start
        # ext with a one-position halo each side; demotion
        e = np.concatenate([[ext[j[0] - 1] if j[0] else 0], ext[j],
                            [ext[j[-1] + 1] if j[-1] + 1 < n else 0]])
        dm = e[:-1].copy()
        if lazy:
            dm[(e[1:] > e[:-1]) & (e[:-1] >= 4) & (e[1:] >= 4)] = 0
        pos = np.arange(lo - 1, hi)
        mt = (dm >= 4) & (pos < valid) & (pos >= start)
        eqp = np.concatenate([[eq[j[0] - 1] if j[0] else False], eq[j][:-1]])
        matched = mt[1:]
        dm = dm[1:]
        boundary = ~(matched & mt[:-1] & eqp)
        rs = np.maximum.accumulate(np.concatenate(
            [[rs_c], np.where(boundary, p, -1)]))[1:]
        rs_c = rs[-1]
        ml_run = np.minimum(dm, 256 - ((p - rs) % 256))
        long_ok = matched & (ml_run >= 32)
        raw = np.where(long_ok, p + ml_run, 0)
        raw_ex = np.maximum.accumulate(np.concatenate([[raw_c], raw]))
        raw_c = raw_ex[-1]
        sel1 = long_ok & (raw_ex[:-1] <= p)
        s1e = np.maximum.accumulate(np.concatenate(
            [[selm_c], np.where(sel1, p + ml_run, 0)]))
        selm_c = s1e[-1]
        covered = s1e[:-1] > p
        # phase 2: one walk per cell, to its end
        ml_short = np.minimum(dm, W - (p % W))
        sel2 = np.zeros(hi - lo, bool)
        vis = np.zeros(hi - lo, bool)
        for cb in range(0, hi - lo, W):
            c = slice(cb, cb + W)
            ones = np.flatnonzero(sel1[c])
            lane = np.arange(W)
            nxt = ones[np.minimum(np.searchsorted(ones, lane, "right"),
                                  len(ones) - 1)] if len(ones) else lane
            cap = np.where((len(ones) > 0) & (nxt > lane), nxt - lane, W)
            ml_short[c] = np.minimum(ml_short[c], cap)
            cands = np.flatnonzero(matched[c] & ~sel1[c] & ~covered[c]
                                   & (ml_short[c] >= 4))
            cur = 0
            while True:
                k = np.searchsorted(cands, cur)
                nxt_c = cands[k] if k < len(cands) else W
                vis[cb + cur:cb + nxt_c] = True
                if nxt_c == W:
                    break
                sel2[cb + nxt_c] = True
                cur = nxt_c + ml_short[cb + nxt_c]
        lit[j] = vis & (p < valid) & ~covered & ~sel1 & ~sel2
        sel[j] = sel1 | sel2
        ml_emit[j] = np.where(sel1, ml_run, ml_short)
    if not hist:
        return ml_emit, sel, lit
    byte = np.asarray(data[start:s], np.int64)
    ll = np.bincount(np.concatenate([
        length_sym(np.maximum(ml_emit[sel], 4)), byte[lit]]),
        minlength=288)
    of = np.bincount(offset_sym(np.clip(dist[start:][sel], 1, 32768)),
                     minlength=30)
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


def test_select_entry_on_cpu_equals_jax_analyze_l6(traps):
    ml, dist, want = traps
    got = psel.select(torch.from_numpy(ml), torch.from_numpy(dist),
                      torch.from_numpy(VALID), torch.from_numpy(ROWS),
                      l6=True)
    _eq(got, want)
