"""The L1-5 match finder: `ops/encode_v2.find_matches_v2_plain` and
numpy models of the CUDA kernel's decomposition (`csrc/match_v2.cu`)
against the JAX package's `find_matches_v2`, on the seeded trap blocks
of `tests/_port_corpus.v2_cases` (the dist kept past the cap, words
reading a non-zero padding, the first element of the sorted order, a
block of one repeated byte, distances 32,767-32,769, valid_len 0-8, a
short last block, w1 differing in byte 0-3 or not at all, block sizes
off the cluster's chunk, the windows of a block past 65,536, and the
collision traps of the sort by hash) and on corpus blocks; plus the
dispatcher on CPU tensors and the block guard. Tolerance: exact
equality (integers).

The kernel cuts a block into windows (`ops/match_v2.windows`: the whole
block up to 65,536 positions, else 32,768 outputs a window with the
32,768 positions before them) and sorts each window's positions stably
by a 16-bit hash of their word (two LSD radix passes of 8 bits, a pass
whose digit is the same for every element skipped). Each element then
compares its word with its sorted neighbour below; where the neighbour
is another word of the same hash within reach, it walks back through
its bucket a run of one word at a time to the first equal word, the
bucket's start or a position more than 32,768 back (`hash_model`). A
window in which a walk would pass WALK_CAP runs of other words is sorted
again by the 4 bytes of the word and swept against each sorted
neighbour (`kernel_model`, the escape path). ml comes from the two next
words' lowest differing byte, then the cap. Mutated copies of
`hash_model` (MUTANTS) each disagree with the JAX function. The kernel
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


MUTANTS = ("no word compare", "stop at the cap", "no reach limit",
           "15-bit sort")


def _walk(order, word, h, cap, mutant=None):
    """The kernel's neighbour compare and walks over a window's list
    sorted by hash: (dist by position, whether a walk passed the cap,
    the most runs of other words a walk passed). A mutant walk may take
    the bucket's neighbour without comparing words, stop at the cap
    without escaping, or ignore the 32,768 limit."""
    n = len(order)
    ws, hs = word[order], h[order]
    edge = np.ones(n, bool)
    edge[1:] = ws[1:] != ws[:-1]
    start = np.maximum.accumulate(np.where(edge, np.arange(n), 0))
    idx = np.arange(1, n)
    j = idx - 1
    passed = np.zeros(n, np.int64)
    res = np.zeros(n, np.int64)
    live = np.ones(n - 1, bool) if n else np.zeros(0, bool)
    escape = False
    while live.any():
        a = np.nonzero(live)[0]
        ii, jj = idx[a], j[a]
        p, q = order[ii], order[jj]
        same = hs[jj] == hs[ii]
        eq = same if mutant == "no word compare" else ws[jj] == ws[ii]
        near = np.ones(len(a), bool) if mutant == "no reach limit" \
            else p - q <= WINDOW
        hit = eq & near
        res[ii[hit]] = (p - q)[hit]
        go = ~eq & same & near
        passed[ii[go]] += 1
        over = go & (passed[ii] == cap)
        escape |= bool(over.any()) and mutant != "stop at the cap"
        go &= ~over
        live[a[~go]] = False
        j[a[go]] = start[jj[go]] - 1
        live[a[go][j[a[go]] < 0]] = False
    dist = np.zeros(n, np.int64)
    dist[order] = res
    return dist, escape, int(passed.max(initial=0))


def hash_model(row, valid, s, cap=None, mutant=None, stats=None):
    """(ml, dist) of one block as csrc/match_v2.cu computes them: each
    window sorted by the 16-bit hash of its words, the neighbour compare
    and walks (`_walk`), and a window whose walk passes the cap taken
    through the escape path, `kernel_model`'s sort by the whole word.
    stats, when given, gets (escaped, most runs passed) per window;
    mutant names one of MUTANTS."""
    cap = match_v2.WALK_CAP if cap is None else cap
    d = row.astype(np.int64)
    ml = np.zeros(s, np.int64)
    dist = np.zeros(s, np.int64)
    exact = None
    for first, out, end in match_v2.windows(s):
        n = end - first
        w = d[first:end + 7]
        word = w[:n] | w[1:n + 1] << 8 | w[2:n + 2] << 16 | w[3:n + 3] << 24
        nxt = (w[4:n + 4] | w[5:n + 5] << 8 | w[6:n + 6] << 16
               | w[7:n + 7] << 24)
        h = ((word * match_v2.HASH_MUL) & 0xFFFFFFFF) >> 16
        key = h & 0x7FFF if mutant == "15-bit sort" else h
        order = _radix(np.arange(n), lambda x, k: key[x] >> 8 * k & 255, 2)
        w_dist, escape, most = _walk(order, word, h, cap, mutant)
        if stats is not None:
            stats.append((escape, most))
        if escape:
            if exact is None:
                exact = kernel_model(row, valid, s)
            ml[out:end] = exact[0][out:end]
            dist[out:end] = exact[1][out:end]
            continue
        # the output: ml from the next words of p and p - dist, the cap
        p = np.arange(n)
        x = nxt[p] ^ nxt[p - w_dist]
        low = (np.frexp((x & -x).astype(np.float64))[1] - 1) // 8
        m = np.where(w_dist > 0, np.where(x == 0, 8, 4 + low), 0)
        m = np.minimum(m, np.clip(valid - (first + p), 0, 8))
        keep = slice(out - first, n)
        ml[out:end] = np.where(m >= 4, m, 0)[keep]
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


@pytest.mark.parametrize("s,i", TRAPS, ids=TRAP_IDS)
def test_hash_model_equals_jax(s, i, want):
    labels, rows, valid = CASES[s]
    stats = []
    ml, dist = hash_model(rows[i], valid[i], s, stats=stats)
    assert np.array_equal(ml, want[s][0][i])
    assert np.array_equal(dist, want[s][1][i])
    # the sort by the whole word only where a trap makes a walk pass
    # the cap
    assert any(e for e, _ in stats) == ("(escape)" in labels[i])


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_hash_model_equals_jax_on_corpus_blocks(kind, corpus_blocks):
    rows, valid, (w_ml, w_dist) = corpus_blocks
    k = CORPUS_KINDS.index(kind)
    for i in (2 * k, 2 * k + 1):
        stats = []
        ml, dist = hash_model(rows[i], valid[i], CORPUS_BLOCK, stats=stats)
        assert np.array_equal(ml, w_ml[i])
        assert np.array_equal(dist, w_dist[i])
        assert not any(e for e, _ in stats)


@pytest.mark.parametrize("mutant", MUTANTS)
def test_mutated_hash_models_fail(mutant, want):
    """Each mutant of the kernel's model disagrees with the JAX function
    on the collision traps: the walk must compare words, escape past the
    cap, stop past 32,768, and the sort must take all 16 bits."""
    wrong = 0
    for s in (1021, 65536):
        labels, rows, valid = CASES[s]
        for i, label in enumerate(labels):
            if "colliding" not in label and "bucket" not in label:
                continue
            ml, dist = hash_model(rows[i], valid[i], s, mutant=mutant)
            wrong += not (np.array_equal(ml, want[s][0][i])
                          and np.array_equal(dist, want[s][1][i]))
    assert wrong > 0


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


def test_collision_traps_are_hit(want):
    """The collision traps reach what they are named for: walks of
    WALK_CAP - 1 runs with a match after them, the cap passed in one or
    two windows, a bucket across the chunks of 4 and 8 blocks, and a
    colliding run whose nearest copy lies 32,769 back."""
    cap = match_v2.WALK_CAP
    for s in (1021, 16384, 65536, 100000):
        labels, rows, valid = CASES[s]
        base = 70000 if s > 65536 else min(100, s // 4) if s < 16384 \
            else s // 2
        for k in (cap - 1, cap, cap + 1):
            i = [j for j, x in enumerate(labels)
                 if x.startswith(f"{k} colliding")][0]
            stats = []
            hash_model(rows[i], valid[i], s, stats=stats)
            a = base + 8 * (k + 2)
            assert want[s][1][i][a] == 8 * (k + 2)
            assert sum(e for e, _ in stats) == (0 if k < cap else
                                                2 if s > 65536 else 1)
            if k < cap:
                assert max(m for _, m in stats) == cap - 1
        i = labels.index("a bucket across the cluster's chunks")
        n = min(s, 65536)
        word = np.asarray(rows[i][:n + 3], np.int64)
        h = ((word[:n] | word[1:n + 1] << 8 | word[2:n + 2] << 16
              | word[3:n + 3] << 24) * match_v2.HASH_MUL
             & 0xFFFFFFFF) >> 16
        mine = h[min(5000, n // 8)]
        lo, hi = (h < mine).sum(), (h <= mine).sum()
        for c, block in ((4, 1), (8, 2)):     # the block the bucket enters
            chunk = ((n + c - 1) // c + 31) // 32 * 32
            assert lo < block * chunk < hi
        # each member's nearest copy: A and C 5 members back, the first B
        # of a run 3 (a walk past A and C), the others 1
        base = min(5000, n // 8)
        for j in range(5, min(600, n // 16)):
            assert want[s][1][i][base + 8 * j] == 8 * (5, 3, 1, 1, 5)[j % 5]
        stats = []
        hash_model(rows[i], valid[i], s, stats=stats)
        assert not any(e for e, _ in stats)
    for s in (65536, 100000):
        labels, rows, valid = CASES[s]
        i = labels.index("a colliding run longer than 32768")
        ml, dist = want[s][0][i], want[s][1][i]
        assert dist[33769] == 0 and ml[33769] == 0
        if s > 98304:
            assert dist[66537] == 32768 and ml[66537] >= 4
        stats = []
        hash_model(rows[i], valid[i], s, stats=stats)
        assert not any(e for e, _ in stats)
        assert hash_model(rows[i], valid[i], s, mutant="no reach limit")[1][
            33769] == 32769


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
