"""The emit step (ops/emit.py): its plain version on CPU tensors against
the JAX package's emit_pack and static coding, and a numpy model of the
emit kernel's decomposition (csrc/emit.cu) against the plain version.
Tolerance: exact equality (the outputs are integers and bytes).

The kernel itself runs only on a card (tests/test_torch_cuda.py). The
model follows the kernel step by step: each lane's token from its own
inputs and, for the riding offset, the lane before it (in its thread of
8 lanes, from the thread before it, or for a warp's first lane read from
the position before it; a thread past the block takes none), each
thread's bit count summed and each row's 4 thread sums scanned as the
shuffles do it, a tile's 64 row sums scanned two a lane by one warp,
each tile's base by the decoupled look-back over the block's earlier
tiles (aggregates and inclusive prefixes, 32 status words at a time,
whichever of them a seeded draw makes visible), the tokens' low and high
words added mod 2^32 into each row's frame words, bits past the frame
dropped, and the row's bytes shifted by delta and zero-padded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import emit_cases, emit_random_cases
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
TR = 64                 # rows a tile
TL = TR * 32            # lanes a tile
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


def model_code(data, ml, dist, sel, lit, ll=None, of=None):
    """Each lane's (val, nb) as the kernel's threads code them: each its
    own token and, in the dynamic mode, the offset part of the lane
    before it, passed in a layout padded to whole tiles: from lane to
    lane in a thread of K lanes, from a thread's last lane to the next
    thread of its warp (a shuffle), into a warp's first lane from the
    position before it (none before the block's first lane); a thread
    past the block's last row takes none."""
    b, s = ml.shape
    width = -(-s // TL) * TL
    byte = data[:, :s].astype(np.int64)
    m = np.maximum(ml, 4)
    d = np.clip(dist, 1, 32768)
    lsym, lev, leb = length_sym(m)
    dsym, dev, deb = offset_sym(d)
    if ll is None:
        hi = byte >= 144
        ln = np.where(hi, 9, 8)
        lv = bitrev(np.where(hi, 0x190 + byte - 144, 0x30 + byte), ln)
        sym8 = lsym >= 280
        nb = np.where(sym8, 8, 7)
        mv = bitrev(np.where(sym8, 0xC0 + lsym - 280, lsym - 256), nb)
        mv |= lev << nb
        nb = nb + leb
        mv |= bitrev(dsym, 5) << nb
        nb = nb + 5
        mv |= dev << nb
        nb = nb + deb
        return tuple(np.pad(x, ((0, 0), (0, width - s))) for x in (
            np.where(sel, mv, np.where(lit, lv, 0)),
            np.where(sel, nb, np.where(lit, ln, 0))))
    rows = np.arange(b)[:, None]
    ent = ll.astype(np.int64)[rows, np.where(sel, np.minimum(lsym, 287),
                                             byte)]
    clen = ent >> 16
    val = (ent & 0xFFFF) | np.where(sel, lev << clen, 0)
    nb = clen + np.where(sel, leb, 0)
    active = sel | lit
    val, nb = np.where(active, val, 0), np.where(active, nb, 0)
    dent = of.astype(np.int64)[rows, dsym]
    dlen = dent >> 16
    dval = np.where(sel, (dent & 0xFFFF) | (dev << dlen), 0)
    dnb = np.where(sel, dlen + deb, 0)
    out = []
    for x in (dval, dnb):
        x = np.pad(x, ((0, 0), (0, width - s))).reshape(b, -1, K)
        prev = np.zeros_like(x)
        prev[..., 1:] = x[..., :-1]                 # within a thread
        prev[:, 1:, 0] = x[:, :-1, K - 1]           # shuffles, and the
        prev = prev.reshape(b, width)               # warps' halo reads
        live = np.arange(width) < -(-s // 32) * 32  # threads of real rows
        out.append(np.where(live, prev, 0))
    pad = ((0, 0), (0, width - s))
    return np.pad(val, pad) | out[0], np.pad(nb, pad) + out[1]


def row_scan(x):
    """Inclusive scan of each row's TPR thread sums, as the shuffles of
    width TPR give it."""
    o = 1
    while o < TPR:
        x = x + np.concatenate([np.zeros_like(x[..., :o]), x[..., :-o]], -1)
        o *= 2
    return x


def warp_scan(x):
    """Inclusive scan along the last axis of 32, as the shuffles give it."""
    o = 1
    while o < 32:
        x = x + np.concatenate([np.zeros_like(x[..., :o]), x[..., :-o]], -1)
        o *= 2
    return x


def look_back(status, k):
    """Warp 0's look-back from tile k: 32 status words at a time, nearest
    first, summing up to and including the nearest inclusive one."""
    total = 0
    for j in range(k - 1, -1, -32):
        words = [status[idx] if idx >= 0 else ("inc", 0)
                 for idx in range(j, j - 32, -1)]
        assert all(w is not None for w in words)    # all published
        first = next((i for i, w in enumerate(words) if w[0] == "inc"), 31)
        total += sum(w[1] for w in words[:first + 1])
        if words[first][0] == "inc":
            return total
    raise AssertionError("tile 0 holds an inclusive prefix")


def model_pack(val, nb, start, row_out, rng, s=None):
    """pack_rows' outputs for blocks of s lanes as the kernel builds them
    from (val, nb) of s lanes or more: a tile's sums count its rows past
    the block too, as the kernel's threads there add theirs."""
    s = val.shape[1] if s is None else s
    width = -(-val.shape[1] // TL) * TL
    val, nb = (np.pad(x, ((0, 0), (0, width - x.shape[1])))
               for x in (val, nb))
    b = val.shape[0]
    r = s // 32
    ntiles = -(-r // TR)
    nwords = row_out // 4
    rows = np.zeros((b, r, row_out + 1), np.uint8)
    byte_off = np.zeros((b, r), np.int64)
    row_bit0 = np.zeros((b, r), np.int64)
    end_bits = np.zeros(b, np.int64)
    for bi in range(b):
        v = val[bi].reshape(-1, TPR, K)[:ntiles * TR].astype(np.int64)
        n = nb[bi].reshape(-1, TPR, K)[:ntiles * TR].astype(np.int64)
        tsum = n.sum(-1)                            # each thread's lanes
        incl = row_scan(tsum)
        # a lane's bits before it in its row: its thread's start, then
        # its thread's earlier lanes in turn
        excl = ((incl - tsum)[..., None] + np.cumsum(n, -1) - n).reshape(
            -1, 32)[:r]
        rowsum = incl[:, -1]
        # warp 0: two rows a lane, scanned
        pairs = rowsum.reshape(ntiles, 32, 2)
        tincl = warp_scan(pairs.sum(-1))
        agg = tincl[:, 31]
        # every tile publishes its aggregate before it looks back; an
        # earlier tile's inclusive prefix is visible or not, by a draw
        status = [("agg", int(a)) for a in agg]
        base = np.zeros(ntiles, np.int64)
        for k in range(ntiles):
            base[k] = start[bi] if k == 0 else look_back(status, k)
            if k == 0 or rng.random() < 0.5:
                status[k] = ("inc", int(base[k] + agg[k]))
        end_bits[bi] = base[-1] + agg[-1]
        e = base[:, None] + tincl - pairs.sum(-1)
        rbase = np.stack([e, e + pairs[..., 0]], -1).reshape(-1)[:r]
        v = v.reshape(-1, 32)[:r]
        bitpos = rbase[:, None] + excl
        word0 = rbase >> 5
        w = (bitpos >> 5) - word0[:, None]
        shift = bitpos & 31
        lo = (v << shift) & MASK
        hi = np.where(shift == 0, 0, v >> (32 - shift))
        words = np.zeros((r, nwords + 2), np.int64)
        ri = np.repeat(np.arange(r), 32).reshape(r, 32)
        np.add.at(words, (ri, np.where(w < nwords, w, nwords + 1)), lo)
        np.add.at(words, (ri, np.where(w + 1 < nwords, w + 1, nwords + 1)),
                  hi)
        words = words[:, :nwords] & MASK
        frame = ((words[..., None] >> (8 * np.arange(4))) & 0xFF).reshape(
            r, row_out)
        delta = (rbase >> 3) - 4 * word0
        src = delta[:, None] + np.arange(row_out + 1)
        rows[bi] = np.where(src < row_out, np.take_along_axis(
            frame, np.minimum(src, row_out - 1), 1), 0)
        byte_off[bi] = rbase >> 3
        row_bit0[bi] = rbase
    return rows, byte_off, row_bit0, end_bits


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
    """The model's packing equals the plain pack_rows on random rows that
    overflow their frames, at start bits 0, 3, 31 and 77, on one row, one
    tile and several tiles with a part."""
    width = {"row": 32, "tile": TL, "tiles": 3 * TL + 96}[width]
    val, nb = overflowing(4, width, seed=width + row_out)
    start = np.array([0, 3, 31, 77], np.int64)
    assert nb[0, :32].sum() > 8 * row_out       # a row past its frame
    want = pev.pack_rows(*tensors(val, nb, start), row_out)
    got = model_pack(val, nb, start, row_out, np.random.default_rng(width))
    for g, w in zip(got, want, strict=True):
        eq(w, g)


def test_model_look_back_any_visibility():
    """The look-back gives each tile's base whichever earlier inclusive
    prefixes are visible: 70 tiles (past two rounds of 32 words)."""
    val, nb = overflowing(1, 70 * TL, seed=5)
    start = np.array([12345], np.int64)
    want = pev.pack_rows(*tensors(val, nb, start), 64)
    for seed in range(3):
        got = model_pack(val, nb, start, 64, np.random.default_rng(seed))
        for g, w in zip(got, want, strict=True):
            eq(w, g)


def model_emit(data, ml, dist, sel, lit, s, ll=None, of=None, start=None,
               seed=0):
    val, nb = model_code(data, ml, dist, sel, lit, ll, of)
    if ll is None:
        start, row_out = np.full(ml.shape[0], 3, np.int64), 48
    else:
        row_out = 64
    return model_pack(val, nb, start, row_out, np.random.default_rng(seed),
                      s)


@pytest.mark.parametrize("make", [emit_cases, emit_random_cases])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_model_emits_the_arrays_as_the_plain_version(mode, make):
    """The model's coding and packing equal the plain version on the trap
    arrays and on random inputs whose rows overflow in both modes."""
    _, data, ml, dist, sel, lit, ll, of, start = make()
    s = ml.shape[1]
    tables = (ll, of, start) if mode == "dynamic" else ()
    want = em.emit(*tensors(data, ml, dist, sel, lit), s, *tensors(*tables))
    got = model_emit(data, ml, dist, sel, lit, s, *tables)
    for g, w in zip(got, want, strict=True):
        eq(w, g)


@pytest.mark.parametrize("tier", ["l6", "l4"])
@pytest.mark.parametrize("kind", KINDS)
def test_model_emits_the_flows_as_the_plain_version(kind, tier, flows):
    """The model on the L6 and L4 tiers' emit inputs (the JAX package's,
    which the port's analyze equals) and on the L1 tier's tokens."""
    data, ml, dist, sel, lit, ll, of, hb = flows[kind][tier]
    args = (data, ml.astype(np.int64), dist.astype(np.int64), sel, lit)
    want = port_dynamic(*args, ll, of, hb, BLOCK)
    got = model_emit(*args, BLOCK, ll, of, hb.astype(np.int64))
    for g, w in zip(got, want, strict=True):
        eq(w, g)
    (arr, ml, dist, sel, lit), _ = flows[kind]["l1"]
    args = (arr, ml.astype(np.int64), dist.astype(np.int64), sel, lit)
    want = em.emit(*tensors(*args), BLOCK)
    for g, w in zip(model_emit(*args, BLOCK), want, strict=True):
        eq(w, g)
