"""The L6 match finder: `ops/match_l6.find_matches_l6` on CPU tensors
(its plain version, `encode_dynamic.find_matches_l6_plain`) against the
JAX package's `find_matches_l6`, and a numpy model of the CUDA kernel's
decomposition (`csrc/match_l6.cu`) against the same, on seeded windows
that hit the function's traps (`tests/_port_corpus.l6_windows`): the
rank rule, hist_start, distances 32,767-32,769, the window's tail and
padding, ties across tiers, the covering decay, valid_len < s.
Tolerance: exact equality (integers).

The kernel keeps the plain version's five stable sorts but sorts
narrower keys: its base sort also holds the 4 positions past the window
(the model checks that a position's rank discounts them), the 8-byte
grid rank pairs the words' dense ranks, the ladder's tail labels lie
above every rank in place of below, and each sort is an LSD radix sort
by 8-bit digits. The kernel itself runs only on a card;
`tests/test_torch_cuda.py` holds it to the plain version there.

One window width (16 KiB blocks) keeps the JAX compile to one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import l6_windows
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import match_l6

torch.set_num_threads(2)
LABELS, ROWS, VALID, HIST_START, S = l6_windows()
WINDOW = 32768
PAY = 17                # payload bits of a kernel sort element
RANK_RULE = ("smallest word 6 times", "zeros", "three 6-byte zero runs")


@pytest.fixture(scope="module")
def want():
    """The JAX package's (ml, dist) of every window."""
    fn = jax.jit(jax.vmap(lambda d, v, h: jed.find_matches_l6(d, v, h, S)))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(ROWS),
                                           jnp.asarray(VALID),
                                           jnp.asarray(HIST_START)))


@pytest.fixture(scope="module")
def port():
    return tuple(x.numpy() for x in match_l6.find_matches_l6(
        torch.from_numpy(ROWS), torch.from_numpy(VALID),
        torch.from_numpy(HIST_START), S))


# ------------------------------------------- numpy model of the kernel
def _radix(e, passes):
    """The kernel's LSD radix sort: stable passes by 8-bit digits of the
    key above the payload."""
    for k in range(passes):
        digit = (e >> np.uint64(PAY + 8 * k)) & np.uint64(255)
        e = e[np.argsort(digit, kind="stable")]
    return e


def _split(e):
    return ((e >> np.uint64(PAY)).astype(np.int64),
            (e & np.uint64((1 << PAY) - 1)).astype(np.int64))


def _dense(keys):
    """Dense rank from 1 of sorted keys (the kernel's block scan)."""
    return np.cumsum(np.concatenate([[1], keys[1:] != keys[:-1]]))


def _prefix(d, a, b, n):
    out = np.zeros(len(a), np.int64)
    alive = np.ones(len(a), bool)
    for k in range(n):
        alive &= d[a + k] == d[b + k]
        out += alive
    return out


def _merge(ml, dist, best_ml, best_dist):
    better = (ml > best_ml) | ((ml == best_ml) & (dist < best_dist)
                              & (ml > 0))
    return np.where(better, ml, best_ml), np.where(better, dist, best_dist)


def _candidates(key, pay, to_pos, n_cand, ok_first, length, hs, rule):
    """The sweep after a sort: candidate j of sorted element i is element
    i - j while its key is equal and it lies within the window and at or
    past hist_start (each test fails for every later j once it fails);
    merged nearest first. Returns (ml, dist) in sorted order."""
    i = np.arange(len(key))
    p = to_pos(pay)
    best_ml = np.zeros(len(key), np.int64)
    best_dist = np.zeros(len(key), np.int64)
    live = ok_first.copy()
    for j in range(1, n_cand + 1):
        prev = np.maximum(i - j, 0)
        q = to_pos(pay[prev])
        live &= (i >= j) & (key[prev] == key) & (p - q <= WINDOW)
        live &= (q >= hs) & rule(i, j)
        ml = np.where(live, length(np.where(live, p, 0),
                                   np.where(live, q, 0)), 0)
        best_ml, best_dist = _merge(ml, np.where(live, p - q, 0), best_ml,
                                    best_dist)
    return best_ml, best_dist


def kernel_model(d, valid, hist_start, s, rank_rule=True):
    """(ml, dist) of one window as csrc/match_l6.cu computes them."""
    d = d.astype(np.int64)
    n, m = s + 4, s // 2
    word = d[:n] | d[1:n + 1] << 8 | d[2:n + 2] << 16 | d[3:n + 3] << 24
    key, pos = _split(_radix(word.astype(np.uint64) << np.uint64(PAY)
                             | np.arange(n, dtype=np.uint64), 4))
    rank = np.zeros(n, np.int64)
    rank[pos] = _dense(key)
    # a position's rank among the window's words discounts the words past
    # the window that sort before it
    ri = np.arange(n) - (word[s:][None, :] < key[:, None]).sum(1)
    ml, dist = _candidates(
        key, pos, lambda x: x, 4, pos < s,
        lambda p, q: 4 + _prefix(d, p + 4, q + 4, 12), hist_start,
        (lambda i, j: ri >= 2 * j) if rank_rule else (lambda i, j: True))
    best_ml = np.zeros(s, np.int64)
    best_dist = np.zeros(s, np.int64)
    inside = pos < s
    best_ml[pos[inside]] = ml[inside]
    best_dist[pos[inside]] = dist[inside]

    g = np.arange(m)
    pair = rank[2 * g] << 17 | rank[2 * g + 4]
    assert pair.max() < 1 << 34          # 5 digits
    key, gs = _split(_radix(pair.astype(np.uint64) << np.uint64(PAY)
                            | g.astype(np.uint64), 5))
    rank = np.zeros(m, np.int64)
    rank[gs] = _dense(key)
    half = 4
    for L in (16, 32, 64):
        ahead = g + half
        kb = np.where(ahead < m, rank[np.minimum(ahead, m - 1)], ahead + 1)
        assert rank.max() < 1 << 16 and kb.max() < 1 << 16   # 4 digits
        key, gs = _split(_radix((rank << 16 | kb).astype(np.uint64)
                                << np.uint64(PAY) | g.astype(np.uint64), 4))
        ml, dist = _candidates(
            key, gs, lambda x: 2 * x, 6, np.ones(m, bool),
            lambda p, q, L=L: L + _prefix(d, p + L, q + L, 8), hist_start,
            lambda i, j: True)
        rank = np.zeros(m, np.int64)
        rank[gs] = _dense(key)
        p = 2 * gs
        best_ml[p], best_dist[p] = _merge(ml, dist, best_ml[p], best_dist[p])
        half = L // 2

    p = np.arange(s)
    packed = np.where(best_ml >= 4, (best_ml + p) << 15
                      | (32768 - np.clip(best_dist, 1, 32768)), 0)
    assert packed.max() < 1 << 32
    cov = np.maximum.accumulate(packed)
    cov_ml = (cov >> 15) - p
    use = (cov_ml > best_ml) & (cov_ml >= 4)
    best_ml = np.where(use, cov_ml, best_ml)
    best_dist = np.where(use, 32768 - (cov & 0x7FFF), best_dist)
    best_ml = np.minimum(best_ml, np.clip(valid - p, 0, 258))
    return np.where(best_ml >= 4, best_ml, 0), best_dist


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("row", range(len(LABELS)), ids=LABELS)
def test_plain_equals_jax(row, want, port):
    assert port[0].dtype == np.int64 and port[0].shape == (len(LABELS), S)
    assert np.array_equal(port[0][row], want[0][row])
    assert np.array_equal(port[1][row], want[1][row])


@pytest.mark.parametrize("row", range(len(LABELS)), ids=LABELS)
def test_kernel_model_equals_jax(row, want):
    ml, dist = kernel_model(ROWS[row], VALID[row], HIST_START[row], S)
    assert np.array_equal(ml, want[0][row])
    assert np.array_equal(dist, want[1][row])


@pytest.mark.parametrize("label", RANK_RULE)
def test_windows_hit_the_rank_rule(label, want):
    """Without the rank rule the model differs from the JAX package on
    these windows: the test set holds the kernel to the rule."""
    row = LABELS.index(label)
    ml, dist = kernel_model(ROWS[row], VALID[row], HIST_START[row], S,
                            rank_rule=False)
    assert not (np.array_equal(ml, want[0][row])
                and np.array_equal(dist, want[1][row]))


def test_windows_hit_the_window_edge(want):
    """The far window holds matches at distances 32,767 and 32,768 and
    none at 32,769; in the tail window a ladder match starts 150 bytes
    before the end, and the final zero run matches up to the window's
    last byte, the zero padding past it cut off by valid_len."""
    far = LABELS.index("distances 32767-32769")
    dists = set(want[1][far][want[0][far] >= 4].tolist())
    assert {32767, 32768} <= dists and 32769 not in dists
    tail = LABELS.index("tail and padding")
    ml = want[0][tail]
    assert ml[S - 150] == 72
    assert (ml[S - 60:S - 3] == np.arange(60, 3, -1)).all()


def test_cpu_tensors_take_the_plain_version():
    before = match_l6.LAUNCHES
    args = (torch.from_numpy(ROWS[:2]), torch.from_numpy(VALID[:2]),
            torch.from_numpy(HIST_START[:2]), S)
    got = match_l6.find_matches_l6(*args, levels=(16, 32))
    plain = ped.find_matches_l6_plain(*args, levels=(16, 32))
    assert match_l6.LAUNCHES == before
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


@pytest.mark.parametrize("s", [(1 << 17) - 258, 49153])
def test_window_guard_raises(s):
    """Windows of 2^17 - 258 bytes and more (and odd ones) raise, as in
    the JAX package, before any work."""
    rows = torch.zeros((1, s + 266), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        match_l6.find_matches_l6(rows, one, one, s)
    with pytest.raises(ValueError):
        ped.find_matches_l6_plain(rows, one, one, s)
    if s % 2 == 0:
        with pytest.raises(ValueError):
            jed.find_matches_l6(jnp.zeros(s + 266, jnp.uint8), 0, 0, s)
