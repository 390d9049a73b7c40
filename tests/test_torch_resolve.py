"""LZ copy resolution: the port's resolve_batch_plain (what resolve_batch
runs on a CPU tensor) against the JAX package's resolve_batch_jax and the
numpy oracle resolve_tokens_np, and a Python mirror of the CUDA kernel
(csrc/resolve.cu) against the plain version.

Cases: those of tests/test_resolve_device.py (literals, overlapping
copies, NOPs, per-offset periodic chains, deep chains, seeded random
columns, a match before the start and output past out_cap), and the
edge columns of tests/_port_corpus.py: 1 MiB runs of one byte and of
distance-4 matches each reading the one before, periodic chains at
distances 2..33, distance 32,768 across windows, matches before the
start in a later window, sums at and just past out_cap, NOP and kind-3
tokens anywhere, a mixed 512 KiB column, token counts that cut the
columns, T == 0 and B == 0. The JAX graph emits nothing for kind 3, as
for a NOP; resolve_tokens_np rejects it, so the oracle reads each
column with its kind-3 tokens taken out.

The mirror follows the kernel's three stages: the single-pass scan
(tiles in ticket order, each look-back seeing a random set of earlier
tiles still at their aggregate), each window's covering map, parents
and pointer jumping in rounds (at windows of 16-64 bytes, so that
markers cross many windows, and at the card's sizes), and the finish's
walk of each stream's windows through a ring of final bytes.

Tolerance: exact (outlen, ok, and the bytes [0, outlen) of ok rows).
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 24)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_corpus as pc
from libdeflate_rsx_tpu.ops.resolve import resolve_batch_jax
from libdeflate_rsx_tpu.ops.tokens import KIND_SHIFT, resolve_tokens_np
from libdeflate_rsx_tpu_torch.ops import resolve as rs
from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch

torch.set_num_threads(2)
assert pc.KIND_SHIFT == KIND_SHIFT


def check(cols, out_cap):
    """Port == JAX == numpy oracle on every stream of the batch."""
    toks = np.stack(cols)
    out, outlen, ok = resolve_batch(torch.from_numpy(toks), out_cap)
    jout, jlen, jok = jax.jit(lambda t: resolve_batch_jax(t, out_cap))(
        jnp.asarray(toks))
    assert out.dtype == torch.uint8 and out.shape == (len(cols), out_cap)
    assert np.array_equal(outlen.numpy(), np.asarray(jlen))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    got = []
    for i, c in enumerate(cols):
        n = int(outlen[i])
        mine = out[i, :n].numpy().tobytes() if bool(ok[i]) else None
        assert mine == (np.asarray(jout)[i, :n].tobytes()
                        if bool(jok[i]) else None)
        assert mine == resolve_tokens_np(c[(c >> KIND_SHIFT) & 3 != 3],
                                         out_cap)
        got.append(mine)
    return got


def test_literals_and_overlaps():
    got = check(*pc.overlap_columns())
    assert got[0] == bytes(range(40))


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 7, 8, 18, 31, 32, 64])
def test_per_offset_patterns(dist):
    (got,) = check(*pc.offset_columns(dist))
    assert got[dist:2 * dist] == got[:dist]


def test_deep_chain_through_mixed_tokens():
    check(*pc.deep_chain_columns())


def test_bad_cases():
    got = check(*pc.bad_columns())
    assert got[1] is None and got[2] is None
    assert len(got[3]) == 16


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_seeded_random_columns(seed):
    check(*pc.random_columns(seed))


EDGE = ["dist-1 run of 1 MiB", "periodic d 2..33", "d 32768 across windows",
        "before the start", "past out_cap", "NOP and kind 3",
        "random kind 3 seed 30", "chained d-4 run of 1 MiB",
        "random 512 KiB seed 32"]


@pytest.mark.parametrize("name", EDGE)
def test_edge_columns(name):
    cols, cap = pc.RESOLVE_CASES[name]()
    got = check(cols, cap)
    if name == "dist-1 run of 1 MiB":
        assert got == [b"\x5a" * cap]
    if name == "chained d-4 run of 1 MiB":
        assert got == [b"\x01\x02\x03\x04" * (cap // 4)]
    if name == "before the start":
        assert [g is None for g in got] == [True, True, False, True]
    if name == "past out_cap":
        assert [g is None for g in got] == [False, True, True, True]
    if name == "NOP and kind 3":
        assert all(g is not None for g in got)


def test_a_4000_match_dist1_chain_at_a_1mib_cap():
    cols, cap = pc.dist1_run_columns()
    assert cap == 1 << 20 and (cols[0] >> KIND_SHIFT == 2).sum() >= 4000
    (got,) = check(cols, cap)
    assert len(got) == cap


def test_token_counts_cut_the_columns():
    """resolve_batch(..., counts): the tokens of row b at or past
    counts[b] emit nothing, as if the column ended there (the JAX graph
    and the oracle get the cut columns)."""
    cols, cap = pc.random_columns(7, n=6, kind3=True)
    toks = np.stack(cols)
    counts = np.array([toks.shape[1], 0, 1, 300, 517, toks.shape[1] + 9],
                      np.int32)
    noisy = toks.copy()
    for i, n in enumerate(counts):
        noisy[i, n:] = pc.match(258, 1)
    got = resolve_batch(torch.from_numpy(noisy), cap,
                        torch.from_numpy(counts))
    cut = np.where(np.arange(toks.shape[1]) < counts[:, None], noisy, 0)
    want = resolve_batch(torch.from_numpy(cut), cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    check(list(cut), cap)
    with pytest.raises(ValueError):
        resolve_batch(torch.from_numpy(noisy), cap,
                      torch.from_numpy(counts[:3]))


def test_empty_shapes():
    """T == 0 (the plain version pads a NOP column; the JAX graph
    cannot index an empty axis, so it gets that column) and B == 0."""
    out, outlen, ok = resolve_batch(torch.zeros((3, 0), dtype=torch.int32),
                                    16)
    pad = np.zeros((3, 1), np.int32)
    jout, jlen, jok = resolve_batch_jax(jnp.asarray(pad), 16)
    assert out.shape == (3, 16) and outlen.tolist() == [0, 0, 0]
    assert np.array_equal(outlen.numpy(), np.asarray(jlen))
    assert np.array_equal(ok.numpy(), np.asarray(jok)) and bool(ok.all())
    assert resolve_tokens_np(np.zeros(0, np.int32), 16) == b""
    for T in (0, 5):
        out, outlen, ok = resolve_batch(
            torch.zeros((0, T), dtype=torch.int32), 16)
        assert out.shape == (0, 16) and outlen.shape == ok.shape == (0,)
    jout, jlen, jok = resolve_batch_jax(jnp.zeros((0, 5), jnp.int32), 16)
    assert np.asarray(jout).shape == (0, 16)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    toks = torch.from_numpy(np.stack(pc.bad_columns()[0]))
    before = rs.LAUNCHES
    got = resolve_batch(toks, 16)
    assert rs.LAUNCHES == before
    want = rs.resolve_batch_plain(toks, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        resolve_batch(toks[0], 16)
    with pytest.raises(ValueError):
        resolve_batch(toks, -1)


# ------------------------------------------------- the kernel's mirror
WIN = 8192                       # csrc/resolve.cu WIN
SCAN_TOKENS = 2048               # csrc/resolve.cu SCAN_TOKENS
CHUNK = 2048                     # csrc/resolve.cu CHUNK
BPT = 16                         # csrc/resolve.cu BPT
MAX_BACK = 257 + 32768           # csrc/resolve.cu MAX_BACK
RING = 65536                     # csrc/resolve.cu RING
HEAD_LIT, HEAD_MATCH = 0x100, 0x8000


def _fields(row):
    row = row.astype(np.int64)
    kind = (row >> KIND_SHIFT) & 3
    ext = np.where(kind == 2, (row & 0xFF) + 3, (kind == 1).astype(np.int64))
    dist = ((row >> 8) & 0x7FFF) + 1
    return kind, ext, dist


def mirror_scan(toks, out_cap, window, tile, counts, rng):
    """scan_kernel: the tiles of each stream in ticket order. A tile that
    emits takes its carry by the look-back (the nearest inclusive sum and
    the aggregates after it); an earlier tile that has published its
    inclusive sum is seen so only at random, as when it is still in
    flight. Returns (win {(b, w): (token, start)}, tend, outlen, ok)."""
    B, T = toks.shape
    ntiles = max(1, -(-T // tile))
    nwin = -(-out_cap // window)
    win, tend = {}, np.zeros(B, np.int64)
    outlen, ok = np.zeros(B, np.int32), np.zeros(B, bool)
    for b in range(B):
        n = T if counts is None else min(max(int(counts[b]), 0), T)
        kind, ext, dist = _fields(toks[b, :n])
        agg, incl = [0] * ntiles, [None] * ntiles
        total, bad = 0, False
        for k in range(ntiles):
            lo, hi = k * tile, min(k * tile + tile, n)
            e = ext[lo:hi] if lo < n else ext[:0]
            agg[k] = tsum = int(e.sum())
            total += tsum
            nz = np.flatnonzero(e)
            if nz.size:
                tend[b] = max(tend[b], lo + nz[-1] + 1)
            if not tsum:
                continue
            excl = 0
            for j in range(k - 1, -1, -1):
                if incl[j] is not None and (j == 0 or rng.random() < 0.5):
                    excl += incl[j]
                    break
                excl += agg[j]
            assert excl == int(ext[:lo].sum())
            incl[k] = excl + tsum
            starts = excl + np.cumsum(e) - e
            bad |= bool(((kind[lo:hi] == 2) & (starts < dist[lo:hi])).any())
            # every window whose first byte an emitting token covers (one
            # at most for windows of 258 bytes or more, as on the card)
            for i in np.flatnonzero(e):
                st = int(starts[i])
                w = -(-st // window)
                while w < nwin and w * window < st + e[i]:
                    win[b, w] = (lo + int(i), st)
                    w += 1
        outlen[b] = min(total, out_cap)
        ok[b] = total <= out_cap and not bad
    return win, tend, outlen, ok


def mirror_window(row, t0, t1, s0, wlen, window, chunk):
    """window_kernel on one window: the covering map built chunk by
    chunk, each byte's covering token by a max-scan over runs of BPT
    bytes and their carries, its parent, then pointer jumping in rounds
    (every round reads the values of the round before, the least that
    the in-place rounds on the card achieve). Returns (values, rounds)."""
    byte0, mark0 = window, window + 255
    head = np.zeros(window, np.int64)
    base = s0
    for c0 in range(t0, t1 + 1, chunk):
        tk = row[c0:min(c0 + chunk, t1 + 1)]
        kind, e, dist = _fields(tk)
        s = base + np.cumsum(e) - e
        code = np.where(kind == 1, HEAD_LIT | (tk & 0xFF),
                        HEAD_MATCH | (dist - 1))
        for j in np.flatnonzero(e):
            if c0 + j == t0:
                head[0] = code[j]
            elif s[j] < wlen:
                assert s[j] >= 1 and head[s[j]] == 0
                head[s[j]] = code[j]
        base += int(e.sum())
    assert head[0] != 0
    p = np.arange(window)
    runs = np.where(head != 0, p, -1).reshape(-1, min(BPT, window))
    local = np.maximum.accumulate(runs, axis=1)
    carry = np.concatenate([[-1], np.maximum.accumulate(local[:, -1])[:-1]])
    hpos = np.maximum(local, carry[:, None]).ravel()
    code = head[hpos]
    s = np.where(hpos == 0, s0, hpos)
    d = (code & 0x7FFF) + 1
    off = p - s
    off = np.where(off >= d, off % d, off)
    q = s - d + off
    x = np.where(code & HEAD_MATCH, np.where(q >= 0, q, mark0 - q),
                 byte0 + (code & 0xFF))
    live = p < wlen
    pend = live & (x < window)
    assert (x[pend] < p[pend]).all()
    rounds = 0
    while pend.any():
        rounds += 1
        nxt = x.copy()
        nxt[pend] = x[x[pend]]
        x = nxt
        pend &= x < window
    assert rounds <= math.ceil(math.log2(window)) + 1
    assert (x[live] - mark0 <= MAX_BACK).all()
    return x[:wlen], rounds


def mirror(toks, out_cap, window, tile=64, chunk=64, counts=None, seed=0):
    """csrc/resolve.cu step for step, in Python, with windows of `window`
    bytes, scan tiles of `tile` tokens and window chunks of `chunk`
    tokens: (out (B, out_cap) uint8, outlen (B,), ok (B,), rounds)
    where rounds holds each ok stream's (most window rounds, finish
    steps); the rows that are not ok stay zero."""
    assert window + MAX_BACK <= RING
    rng = np.random.default_rng(seed)
    B, T = toks.shape
    win, tend, outlen, ok = mirror_scan(toks, out_cap, window, tile, counts,
                                        rng)
    byte0, mark0 = window, window + 255
    out = np.zeros((B, out_cap), np.uint8)
    rounds = {}
    for b in np.flatnonzero(ok):
        n = int(outlen[b])
        row = toks[b].astype(np.int64)
        nw = -(-n // window)
        vals = np.zeros(nw * window, np.int64)
        wrounds = 0
        # window_kernel: every window on its own, in a random order
        for w in rng.permutation(nw):
            ws = int(w) * window
            wlen = min(n - ws, window)
            t0, st0 = win[b, w]
            t1 = win[b, w + 1][0] if ws + window < n else int(tend[b]) - 1
            x, r = mirror_window(row, t0, t1, st0 - ws, wlen, window, chunk)
            wrounds = max(wrounds, r)
            vals[ws:ws + wlen] = x
        # finish_kernel: the windows in order, each one gather from a ring
        # of the last RING final bytes
        ring, held = np.zeros(RING, np.int64), np.full(RING, -1)
        for w in range(nw):
            ws = w * window
            p = np.arange(ws, min(ws + window, n))
            v = vals[p]
            mk = v > mark0
            src = ws - (v[mk] - mark0)
            assert (held[src % RING] == src).all()
            got = np.where(mk, 0, v - byte0)
            got[mk] = ring[src % RING]
            ring[p % RING], held[p % RING] = got, p
            out[b, p] = got
        rounds[int(b)] = (wrounds, nw)
    return out, outlen, ok, rounds


def mirror_vs_plain(cols, out_cap, window, counts=None, **kw):
    toks = np.stack(cols)
    out, outlen, ok, rounds = mirror(toks, out_cap, window, counts=counts,
                                     **kw)
    pout, plen, pok = rs.resolve_batch_plain(
        torch.from_numpy(toks), out_cap,
        None if counts is None else torch.from_numpy(counts))
    assert np.array_equal(outlen, plen.numpy())
    assert np.array_equal(ok, pok.numpy())
    for i in np.flatnonzero(ok):
        n = outlen[i]
        assert np.array_equal(out[i, :n], pout[i, :n].numpy()), i
    return ok, rounds


@pytest.mark.parametrize("window", [16, 32, 64])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_mirror_equals_plain_on_seeded_columns(seed, window):
    """Windows of 16-64 bytes: every match's source lies windows back,
    so markers cross many windows."""
    cols, cap = pc.random_columns(seed, n=8, kind3=True)
    ok, _ = mirror_vs_plain(cols, cap, window, seed=seed)
    assert ok.all()


@pytest.mark.parametrize("window", [64, 4096])
@pytest.mark.parametrize("name", ["dist-1 run of 1 MiB",
                                  "d 32768 across windows",
                                  "before the start", "past out_cap"])
def test_mirror_equals_plain_on_edge_columns(name, window):
    cols, cap = pc.RESOLVE_CASES[name]()
    mirror_vs_plain(cols, cap, window, tile=512, chunk=256)


@pytest.mark.parametrize("window", [48, 4096])
def test_mirror_equals_plain_on_periodic_and_small_cases(window):
    """Periodic chains at distances 2..33 (every other one) and the
    small hand-built batches."""
    cols, cap = pc.periodic_columns(cap=8192)
    mirror_vs_plain(cols[::2], cap, window)
    for name in list(pc.RESOLVE_CASES)[:15]:
        mirror_vs_plain(*pc.RESOLVE_CASES[name](), window)


@pytest.mark.parametrize("name", ["dist-1 run of 1 MiB",
                                  "chained d-4 run of 1 MiB",
                                  "d 32768 across windows", "NOP and kind 3",
                                  "random kind 3 seed 31",
                                  "random 512 KiB seed 32"])
def test_mirror_at_the_kernels_sizes(name):
    """The card's window, scan tile and chunk sizes."""
    cols, cap = pc.RESOLVE_CASES[name]()
    mirror_vs_plain(cols, cap, WIN, tile=SCAN_TOKENS, chunk=CHUNK)


@pytest.mark.parametrize("window", [64, WIN])
def test_mirror_finish_steps_on_the_dist1_run(window):
    """The 1 MiB run of one byte chains every window to the one before:
    the finish takes one step a window, each a gather from the ring of
    final bytes (no chain to follow), and the windows' pointer jumping
    stays within ceil(log2(window)) + 1 rounds; so does a chain of
    distance-4 matches, each reading the one before (rounds, not a step
    per match)."""
    for name in ("dist-1 run of 1 MiB", "chained d-4 run of 1 MiB"):
        cols, cap = pc.RESOLVE_CASES[name]()
        _, rounds = mirror_vs_plain(cols, cap, window, tile=1024, chunk=512)
        wr, steps = rounds[0]
        assert steps == -(-cap // window)
        assert 0 < wr <= math.ceil(math.log2(window)) + 1, (name, wr)


@pytest.mark.parametrize("window", [32, WIN])
def test_mirror_with_token_counts(window):
    """Counts cut each column: tokens past them (here seeded noise) are
    not read, as the plain version ignores them."""
    cols, cap = pc.random_columns(6, n=6, kind3=True)
    rng = np.random.default_rng(6)
    toks = np.stack(cols)
    counts = rng.integers(0, toks.shape[1] + 40, len(cols)).astype(np.int32)
    counts[0] = toks.shape[1]
    noisy = toks.copy()
    for i, n in enumerate(counts):
        noisy[i, n:] = pc.lit(0x33) if i % 2 else pc.match(3, 1)
    ok, _ = mirror_vs_plain(list(noisy), cap, window, counts=counts)
    assert ok[0]
