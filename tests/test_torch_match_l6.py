"""The L6 match finder: `ops/match_l6.find_matches_l6` on CPU tensors
(its plain version, `encode_dynamic.find_matches_l6_plain`) against the
JAX package's `find_matches_l6`, and a numpy model of the CUDA kernel's
decomposition (`csrc/match_l6.cu`) against the same, on seeded windows
that hit the function's traps (`tests/_port_corpus.l6_windows`): the
rank rule, hist_start, distances 32,767-32,769, the window's tail and
padding, ties across tiers, the covering decay, valid_len < s; and on
windows at the extremes of the ladder's group sizes (random bytes: no
groups past the base tier; zeros: one group; a long run inside random
bytes or text: one large group among singletons).
Tolerance: exact equality (integers).

The kernel sorts the window's positions by word (an LSD radix sort by
the word's bytes, with the 4 positions past the window: the model checks
that a position's rank discounts them), lists the grid (the even
positions) in that order, labels each grid position with the first
member of its word group, and then refines only the groups of two or
more, level by level (8-byte, L16, L32, L64): the level's active list,
which holds each group of the level below in one run, is stably sorted
by the label at g + L/4 alone (equal pairs stay together, in grid
order) and relabelled, its groups of one drop out and keep their labels,
and a partner past the grid takes a label above every grid position. The kernel itself runs only on a card;
`tests/test_torch_cuda.py` holds it to the plain version there.

One window width (16 KiB blocks) keeps the JAX compile to one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import l6_windows, make_corpus
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import match_l6

torch.set_num_threads(2)
LABELS, ROWS, VALID, HIST_START, S = l6_windows()
WINDOW = 32768
RANK_RULE = ("smallest word 6 times", "zeros", "three 6-byte zero runs")


def _group_windows():
    """Windows at the extremes of the ladder's group sizes, of the trap
    windows' width and row padding."""
    rng = np.random.default_rng(12)
    noise = rng.integers(0, 256, S, dtype=np.uint8)
    run_noise = noise.copy()
    run_noise[20000:30000] = 7
    run_text = np.frombuffer(make_corpus("text", S, seed=12),
                             np.uint8).copy()
    run_text[30000:36000] = ord(" ")
    rows = np.zeros((3, ROWS.shape[1]), np.uint8)
    rows[:, :S] = (noise, run_noise, run_text)
    return (("random bytes", "long run in random bytes", "long run in text"),
            rows)


GROUP_LABELS, GROUP_ROWS = _group_windows()
ALL_LABELS = LABELS + list(GROUP_LABELS)
ALL_ROWS = np.concatenate([ROWS, GROUP_ROWS])
ALL_VALID = np.concatenate([VALID, np.full(3, S, np.int32)])
ALL_HIST = np.concatenate([HIST_START, np.zeros(3, np.int32)])


@pytest.fixture(scope="module")
def want():
    """The JAX package's (ml, dist) of every window."""
    fn = jax.jit(jax.vmap(lambda d, v, h: jed.find_matches_l6(d, v, h, S)))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(ALL_ROWS),
                                           jnp.asarray(ALL_VALID),
                                           jnp.asarray(ALL_HIST)))


@pytest.fixture(scope="module")
def port():
    return tuple(x.numpy() for x in match_l6.find_matches_l6(
        torch.from_numpy(ROWS), torch.from_numpy(VALID),
        torch.from_numpy(HIST_START), S))


# ------------------------------------------- numpy model of the kernel
def _radix(idx, digit, passes):
    """The kernel's LSD radix sort of a list: stable passes by the 8-bit
    digits of each element's key, a pass whose digit is the same for
    every element skipped."""
    for k in range(passes):
        d = digit(idx, k)
        if len(d) and not (d == d[0]).all():
            idx = idx[np.argsort(d, kind="stable")]
    return idx


def _groups(key):
    """Group starts of a sorted key: (boundary flags, the index of each
    element's group start, whether its group has two or more)."""
    n = len(key)
    b = np.ones(n, bool)
    b[1:] = key[1:] != key[:-1]
    start = np.maximum.accumulate(np.where(b, np.arange(n), 0))
    return b, start, ~(b & np.append(b[1:], True))


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


def _candidates(pos, start, n_cand, length, hs, rule):
    """The sweep after a sort: candidate j of sorted element i is element
    i - j while it is in i's group, within the window and at or past
    hist_start (each test fails for every later j once it fails); merged
    nearest first. pos: each sorted element's position. Returns (ml,
    dist) in sorted order."""
    i = np.arange(len(pos))
    best_ml = np.zeros(len(pos), np.int64)
    best_dist = np.zeros(len(pos), np.int64)
    live = np.ones(len(pos), bool)
    for j in range(1, n_cand + 1):
        q = pos[np.maximum(i - j, 0)]
        live &= (i - j >= start) & (pos - q <= WINDOW) & (q >= hs) & rule(j)
        ml = np.where(live, length(np.where(live, pos, 0),
                                   np.where(live, q, 0)), 0)
        best_ml, best_dist = _merge(ml, np.where(live, pos - q, 0), best_ml,
                                    best_dist)
    return best_ml, best_dist


def kernel_model(d, valid, hist_start, s, rank_rule=True, lists=None):
    """(ml, dist) of one window as csrc/match_l6.cu computes them; lists,
    when given, gets (size, largest group) of the active list each ladder
    level sorts (8-byte, L16, L32, L64)."""
    d = d.astype(np.int64)
    n, m = s + 4, s // 2
    word = d[:n] | d[1:n + 1] << 8 | d[2:n + 2] << 16 | d[3:n + 3] << 24
    # base tier: the positions sorted by the bytes of their word
    pos = _radix(np.arange(n), lambda x, k: d[x + k], 4)
    key = word[pos]
    _, start, _ = _groups(key)
    # a position's rank among the window's words discounts the words past
    # the window that sort before it
    ri = np.arange(n) - (word[s:][None, :] < key[:, None]).sum(1)
    ml, dist = _candidates(
        pos, start, 4, lambda p, q: 4 + _prefix(d, p + 4, q + 4, 12),
        hist_start, (lambda j: ri >= 2 * j) if rank_rule
        else (lambda j: True))
    best_ml = np.zeros(s, np.int64)
    best_dist = np.zeros(s, np.int64)
    inside = pos < s
    best_ml[pos[inside]] = ml[inside]
    best_dist[pos[inside]] = dist[inside]

    # the grid (even positions 0..s + 2) in word order: labels and the
    # active list of grid positions in groups of two or more
    grid = pos[pos % 2 == 0] // 2
    assert len(grid) == m + 2
    _, start, rep = _groups(word[2 * grid])
    label = np.zeros(m + 2, np.int64)
    label[grid] = grid[start]
    act = grid[rep & (grid < m)]
    for level, L in enumerate((8, 16, 32, 64)):
        half = 2 << level
        ahead = act + half
        kb = label[ahead] if L == 8 else             np.where(ahead < m, label[np.minimum(ahead, m + 1)], ahead + 1)
        assert kb.max(initial=0) < 1 << 16                # 2 digits

        def partner(x, L=L, half=half):
            return label[x + half] if L == 8 else np.where(
                x + half < m, label[np.minimum(x + half, m + 1)], x + half + 1)
        # the list holds each group of the level below in one run, so a
        # stable sort by the partner's label alone keeps equal pairs
        # together, in grid order
        act = _radix(act, lambda x, k: (partner(x) >> (8 * k)) & 255, 2)
        pair = label[act] << 16 | partner(act)
        _, start, rep = _groups(pair)
        if lists is not None:
            sizes = np.bincount(start) if len(act) else np.zeros(1, int)
            lists.append((len(act), int(sizes.max())))
        if L > 8:
            cml, cd = _candidates(
                2 * act, start, 6,
                lambda p, q, L=L: L + _prefix(d, p + L, q + L, 8),
                hist_start, lambda j: True)
            p = 2 * act
            best_ml[p], best_dist[p] = _merge(cml, cd, best_ml[p],
                                              best_dist[p])
        label[act] = act[start]
        act = act[rep]

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


@pytest.mark.parametrize("row", range(len(ALL_LABELS)), ids=ALL_LABELS)
def test_kernel_model_equals_jax(row, want):
    ml, dist = kernel_model(ALL_ROWS[row], ALL_VALID[row], ALL_HIST[row], S)
    assert np.array_equal(ml, want[0][row])
    assert np.array_equal(dist, want[1][row])


@pytest.mark.parametrize("label", ["random bytes", "zeros",
                                   "long run in random bytes",
                                   "long run in text"])
def test_model_group_sizes(label):
    """The windows reach the extremes of the ladder's active lists: none
    past the base tier (random bytes), all one group (zeros), one large
    group among singletons (a long run)."""
    row = ALL_LABELS.index(label)
    lists = []
    kernel_model(ALL_ROWS[row], ALL_VALID[row], ALL_HIST[row], S,
                 lists=lists)
    sizes, largest = zip(*lists)
    m = S // 2
    if label == "random bytes":
        assert max(sizes) <= 4
    elif label == "zeros":
        # one group; at each level only the grid positions whose partner
        # runs past the grid (up to L/4 of them) stand apart
        assert sizes[0] == largest[0] == m
        assert all(a - b <= 16 and a >= m - 32
                   for a, b in zip(sizes, largest))
    else:
        # the run's grid positions (5,000 or 3,000) form one group to the
        # last level; in random bytes little else is left
        run = 5000 if "random" in label else 3000
        assert all(b >= run - 40 for b in largest)
        if "random" in label:
            assert all(a - b <= 16 for a, b in zip(sizes, largest))


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
