"""The L1-5 match finder: `ops/encode_v2.find_matches_v2_plain` and a
numpy model of the CUDA kernel's decomposition (`csrc/match_v2.cu`)
against the JAX package's `find_matches_v2`, on the seeded trap blocks
of `tests/_port_corpus.v2_cases` (the dist kept past the cap, words
reading a non-zero padding, the first element of the sorted order, a
block of one repeated byte, distances 32,767-32,769, valid_len 0-8, a
short last block, w1 differing in byte 0-3 or not at all, block sizes
off the cluster's chunk, the windows of a block past 65,536) and on
corpus blocks; plus the dispatcher on CPU tensors and the block guard.
Tolerance: exact equality (integers).

The kernel cuts a block into windows (`ops/match_v2.windows`: the whole
block up to 65,536 positions, else 32,768 outputs a window with the
32,768 positions before them), sorts each window's positions stably by
the 4 bytes of their word (LSD radix passes, a pass whose digit is the
same for every element skipped), and sweeps the sorted list once: each
element against its neighbour below, ml from the two next words' lowest
differing byte, the cap, (ml, dist) stored by position. The kernel
itself runs only on a card; `tests/test_torch_cuda.py` holds it to the
plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import V2_SIZES, make_corpus, v2_cases
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu_torch.models import greedy_static as pgs
from libdeflate_rsx_tpu_torch.ops import encode_v2 as pev
from libdeflate_rsx_tpu_torch.ops import match_v2

torch.set_num_threads(2)
WINDOW = 32768
CASES = {s: v2_cases(s) for s in V2_SIZES}
TRAPS = [(s, i) for s in V2_SIZES for i in range(len(CASES[s][0]))]
TRAP_IDS = [f"{s}-{CASES[s][0][i]}" for s, i in TRAPS]
CORPUS_KINDS = ("text", "pattern", "random", "zeros", "periodic:7")
CORPUS_BLOCK = 65536


def _jax(rows, valid, s):
    fn = jax.jit(jax.vmap(functools.partial(jev.find_matches_v2,
                                            block_size=s)))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(rows),
                                           jnp.asarray(valid)))


@pytest.fixture(scope="module")
def want():
    """The JAX package's (ml, dist) of every trap block, by size."""
    return {s: _jax(CASES[s][1], CASES[s][2], s) for s in V2_SIZES}


@pytest.fixture(scope="module")
def plain():
    """find_matches_v2 on CPU tensors (its plain version), by size."""
    return {s: tuple(x.numpy() for x in pev.find_matches_v2(
        torch.from_numpy(CASES[s][1]), torch.from_numpy(CASES[s][2]), s))
        for s in V2_SIZES}


@pytest.fixture(scope="module")
def corpus_blocks():
    """Seeded corpus items of each kind, split into 65,536-byte blocks (a
    whole block and a short last one) as the L1-5 tiers split them, with
    the JAX package's (ml, dist)."""
    rows, valid = [], []
    for kind in CORPUS_KINDS:
        arr, v, _, _ = pgs.split_blocks(make_corpus(kind, 100000, seed=4),
                                        CORPUS_BLOCK)
        rows.append(arr)
        valid.append(v)
    rows, valid = np.concatenate(rows), np.concatenate(valid)
    return rows, valid, _jax(rows, valid, CORPUS_BLOCK)


# ------------------------------------------- numpy model of the kernel
def _radix(idx, digit, passes, ran=None):
    """The kernel's LSD radix sort of a list: stable passes by 8-bit
    digits, a pass whose digit is the same for every element skipped
    (ran, when given, gets the passes that moved the list)."""
    for k in range(passes):
        d = digit(idx, k)
        if len(d) and not (d == d[0]).all():
            idx = idx[np.argsort(d, kind="stable")]
            if ran is not None:
                ran.append(k)
    return idx


def kernel_model(row, valid, s, ran=None):
    """(ml, dist) of one block as csrc/match_v2.cu computes them; ran,
    when given, gets the radix passes each window ran."""
    d = row.astype(np.int64)
    ml = np.zeros(s, np.int64)
    dist = np.zeros(s, np.int64)
    for first, out, end in match_v2.windows(s):
        n = end - first
        w = d[first:end + 7]
        word = w[:n] | w[1:n + 1] << 8 | w[2:n + 2] << 16 | w[3:n + 3] << 24
        nxt = (w[4:n + 4] | w[5:n + 5] << 8 | w[6:n + 6] << 16
               | w[7:n + 7] << 24)
        passes = []
        order = _radix(np.arange(n), lambda x, k: w[x + k], 4, passes)
        if ran is not None:
            ran.append(passes)
        # the sweep: each sorted element against its neighbour below
        p, q = order[1:], order[:-1]
        ok = (word[p] == word[q]) & (p - q <= WINDOW)
        x = nxt[p] ^ nxt[q]
        low = (np.frexp((x & -x).astype(np.float64))[1] - 1) // 8
        m = np.where(ok, np.where(x == 0, 8, 4 + low), 0)
        m = np.minimum(m, np.clip(valid - (first + p), 0, 8))
        w_ml = np.zeros(n, np.int64)
        w_dist = np.zeros(n, np.int64)
        w_ml[p] = np.where(m >= 4, m, 0)
        w_dist[p] = np.where(ok, p - q, 0)
        keep = slice(out - first, n)
        ml[out:end] = w_ml[keep]
        dist[out:end] = w_dist[keep]
    return ml, dist


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("s,i", TRAPS, ids=TRAP_IDS)
def test_plain_equals_jax(s, i, want, plain):
    for got, ref in zip(plain[s], want[s]):
        assert got.dtype == np.int64 and got.shape == (len(CASES[s][0]), s)
        assert np.array_equal(got[i], ref[i])


@pytest.mark.parametrize("s,i", TRAPS, ids=TRAP_IDS)
def test_kernel_model_equals_jax(s, i, want):
    _, rows, valid = CASES[s]
    ml, dist = kernel_model(rows[i], valid[i], s)
    assert np.array_equal(ml, want[s][0][i])
    assert np.array_equal(dist, want[s][1][i])


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_kernel_model_equals_jax_on_corpus_blocks(kind, corpus_blocks):
    rows, valid, (w_ml, w_dist) = corpus_blocks
    k = CORPUS_KINDS.index(kind)
    for i in (2 * k, 2 * k + 1):
        ml, dist = kernel_model(rows[i], valid[i], CORPUS_BLOCK)
        assert np.array_equal(ml, w_ml[i])
        assert np.array_equal(dist, w_dist[i])


def test_traps_are_hit(want):
    """The trap blocks reach what they are named for."""
    s = 65536
    labels, rows, valid = CASES[s]
    ml, dist = want[s]
    # the dist kept past the cap: ml 0 and dist > 0 at and past valid_len
    for v in range(9):
        i = labels.index(f"valid_len {v}")
        assert (ml[i][v:] == 0).all()
        assert (dist[i][max(v - 3, 0):] > 0).any()
    # ml 4-8 from w1
    i = labels.index("w1 differs in byte 0-3 or not at all")
    assert set(ml[i][ml[i] > 0].tolist()) >= {4, 5, 6, 7, 8}
    # 32,767 and 32,768 match, 32,769 does not, nor does an older copy
    i = labels.index("distances 32767-32769")
    assert ml[i][33000] == 8 and dist[i][33000] == 32767
    assert ml[i][40000] == 8 and dist[i][40000] == 32768
    assert ml[i][45000] == 0 and dist[i][45000] == 0
    i = labels.index("nearest 32769 back, older further")
    assert ml[i][50000] == 0 and dist[i][50000] == 0
    assert ml[i][60000] == 8 and dist[i][60000] == 20000
    # the smallest word first: position 0 leads the sorted order
    i = labels.index("smallest word first")
    assert ml[i][0] == 0 and dist[i][1] == 1 and dist[i][s // 2] > 0
    # a block of one repeated byte: every radix pass skipped, every
    # predecessor p - 1
    i = labels.index("one repeated byte")
    ran = []
    kernel_model(rows[i], valid[i], s, ran)
    assert ran == [[]] and (dist[i][1:] == 1).all() and dist[i][0] == 0
    # the window edges of a longer block
    s = 100000
    labels, rows, valid = CASES[s]
    i = labels.index("window edges")
    ml, dist = want[s][0][i], want[s][1][i]
    assert len(match_v2.windows(s)) == 4
    assert ml[65536] == 8 and dist[65536] == 32768
    assert ml[65576] == 0 and dist[65576] == 0
    assert ml[98316] == 8 and dist[98316] == 32768


def test_cpu_tensors_take_the_plain_version():
    _, rows, valid = CASES[1024]
    before = match_v2.LAUNCHES
    args = (torch.from_numpy(rows[:3]), torch.from_numpy(valid[:3]), 1024)
    got = pev.find_matches_v2(*args)
    want = pev.find_matches_v2_plain(*args)
    assert match_v2.LAUNCHES == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    empty = pev.find_matches_v2(torch.zeros((0, 1290), dtype=torch.uint8),
                                torch.zeros(0, dtype=torch.int32), 1024)
    assert [tuple(x.shape) for x in empty] == [(0, 1024), (0, 1024)]
    with pytest.raises(ValueError):
        match_v2.find_matches_v2_cuda(*args)
    assert match_v2.LAUNCHES == before


@pytest.mark.parametrize("s", [1, 65536, 65537, 262144])
def test_block_guard_accepts(s):
    match_v2.check_v2_block(s)


@pytest.mark.parametrize("s", [0, -1, match_v2.MAX_BLOCK + 1])
def test_block_guard_raises(s):
    with pytest.raises(ValueError):
        match_v2.check_v2_block(s)
    rows = torch.zeros((1, 300), dtype=torch.uint8)
    with pytest.raises(ValueError):
        pev.find_matches_v2(rows, torch.ones(1, dtype=torch.int32), s)


def test_windows_cover_every_position():
    """Each position past 65,536 is an output of exactly one window, which
    holds the 32,768 positions before it."""
    for s in (65536, 65537, 100000, 262144, 262145):
        wins = match_v2.windows(s)
        outs = np.concatenate([np.arange(o, e) for _, o, e in wins])
        assert np.array_equal(outs, np.arange(s))
        assert all(e - f <= match_v2.WINDOW_MAX
                   and (f == 0 or o - f == match_v2.REACH)
                   for f, o, e in wins)
