"""The device table step (ops/dyn_tables.py) on the CPU.

1. A Python mirror of the CUDA kernel's package-merge (csrc/dyn_tables.cu:
   the leaves sorted by (frequency, symbol) merged at every level with the
   packages keyed by (weight, first symbol), each symbol's length counted
   from the selected prefix of every level) against the port's
   `length_limited_lengths`, which sorts whole (weight, symbols) tuples,
   on seeded histograms with many ties, at the widths and limits the
   kernel runs (19 precode symbols at 7 bits, 30 offsets at 15, 288
   litlen symbols at 14) and the others of those.
2. The plain version `build_tables_plain` against the JAX package's
   `_build_tables_py` (the builder it runs while its native codec does
   not build) on random and edge histograms: tables, header bytes and
   header bits.

Tolerance: exact equality (integers and bytes). The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import itertools

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.ops.encode_dynamic import _build_tables_py
from libdeflate_rsx_tpu_torch.models.portable.huffman import (
    length_limited_lengths,
)
from libdeflate_rsx_tpu_torch.ops import dyn_tables as dt

WIDTHS = (19, 30, 288)
LIMITS = (7, 14, 15)


def merge_lengths(freqs, max_len: int) -> list[int]:
    """The kernel's package-merge, step for step, in Python."""
    freqs = [int(x) for x in freqs]
    lens = [0] * len(freqs)
    active = [s for s, f in enumerate(freqs) if f]
    n = len(active)
    if n <= 1:
        for s in active:
            lens[s] = 1
        return lens
    ls = sorted(active, key=lambda s: (freqs[s], s))
    lw = [freqs[s] for s in ls]
    w, f = lw[:], ls[:]
    posl = [list(range(n))]
    cnt = [n]
    for _ in range(1, max_len):
        pw = [w[2 * p] + w[2 * p + 1] for p in range(len(w) // 2)]
        pf = [f[2 * p] for p in range(len(w) // 2)]
        nw, nf, pos = [], [], []
        i = p = 0
        while i < n or p < len(pw):
            if p == len(pw) or (i < n and (lw[i] < pw[p] or (
                    lw[i] == pw[p] and ls[i] <= pf[p]))):
                pos.append(len(nw))
                nw.append(lw[i])
                nf.append(ls[i])
                i += 1
            else:
                nw.append(pw[p])
                nf.append(pf[p])
                p += 1
        w, f = nw, nf
        posl.append(pos)
        cnt.append(len(w))
    c = min(2 * n - 2, cnt[-1])
    for k in reversed(range(max_len)):
        take = sum(x < c for x in posl[k])
        for i in range(take):
            lens[ls[i]] += 1
        c = 2 * (c - take)
    return lens


def tie_histograms(width: int, limit: int, count: int, seed: int):
    """Seeded histograms of `width` bins with at most 2**limit used
    symbols: counts from {0, 1}, {0, 1, 2}, up to 65,535, and geometric
    (Fibonacci) counts that force the length limit; some sparse."""
    rng = np.random.default_rng(seed)
    fib = [1, 1]
    while fib[-1] < 65535:
        fib.append(fib[-1] + fib[-2])
    fib = np.array(fib[:-1])
    out = []
    for k in range(count):
        kind = k % 5
        if kind == 0:
            h = rng.integers(0, 2, width)
        elif kind == 1:
            h = rng.integers(0, 3, width)
        elif kind == 2:
            h = rng.integers(0, 65536, width) * (rng.random(width) < 0.6)
        elif kind == 3:
            h = rng.choice(fib, width) * (rng.random(width) < 0.8)
        else:
            h = np.zeros(width, np.int64)
            used = rng.choice(width, rng.integers(1, min(width, 6) + 1),
                              replace=False)
            h[used] = rng.integers(1, 4, len(used))
        nz = np.flatnonzero(h)
        if len(nz) > (1 << limit):
            h[rng.choice(nz, len(nz) - (1 << limit), replace=False)] = 0
        out.append(h.astype(np.int64))
    return out


@pytest.mark.parametrize("width,limit", itertools.product(WIDTHS, LIMITS))
def test_merge_mirror_equals_length_limited_lengths(width, limit):
    count = 400 if width == 288 else 600
    for h in tie_histograms(width, limit, count, seed=width * 100 + limit):
        want = length_limited_lengths(h, limit).tolist()
        assert merge_lengths(h, limit) == want, (width, limit, h.tolist())
        assert max(want) <= limit


def edge_histograms():
    """(ll_hist (288,), of_hist (30,)) pairs: an empty block, one used
    literal, all 288 symbols used, every count saturated at 65,535,
    geometric counts that pass the 14-bit litlen limit, one offset
    symbol, offset symbol 0 alone, the last offset symbol alone."""
    fib = [1, 1]
    while len(fib) < 288:
        fib.append(min(fib[-1] + fib[-2], 65535))
    z_ll, z_of = np.zeros(288, np.int64), np.zeros(30, np.int64)
    one_lit = z_ll.copy()
    one_lit[65] = 9
    geo = np.array(fib, np.int64)
    of_one, of_zero, of_last = z_of.copy(), z_of.copy(), z_of.copy()
    of_one[7], of_zero[0], of_last[29] = 3, 5, 1
    return [
        (z_ll, z_of), (one_lit, z_of), (one_lit, of_one),
        (np.ones(288, np.int64), np.ones(30, np.int64)),
        (np.full(288, 65535, np.int64), np.full(30, 65535, np.int64)),
        (geo, np.array(fib[:30], np.int64)), (geo[::-1].copy(), of_zero),
        (np.arange(288, dtype=np.int64), of_last),
    ]


def random_histograms(count: int, seed: int):
    """Histograms shaped like real blocks' (literals dense, lengths and
    offsets sparse) and tie-heavy ones."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        ll = np.zeros(288, np.int64)
        of = np.zeros(30, np.int64)
        if k % 2:
            ll[:256] = rng.integers(0, 3, 256)
            ll[257:286] = rng.integers(0, 2, 29)
            of[:] = rng.integers(0, 2, 30)
        else:
            ll[:256] = rng.geometric(0.02, 256) * (rng.random(256) < 0.7)
            ll[257:286] = rng.geometric(0.05, 29) * (rng.random(29) < 0.5)
            of[:] = rng.geometric(0.1, 30) * (rng.random(30) < 0.6)
        out.append((np.minimum(ll, 65535), np.minimum(of, 65535)))
    return out


def test_plain_equals_jax_builder():
    cases = edge_histograms() + random_histograms(96, seed=5)
    ll = torch.from_numpy(np.stack([c[0] for c in cases])).to(torch.uint16)
    of = torch.from_numpy(np.stack([c[1] for c in cases])).to(torch.uint16)
    finals = torch.from_numpy(np.arange(len(cases)) % 3 == 0)
    got = dt.build_tables(ll, of, finals)       # a CPU tensor: the plain one
    assert dt.LAUNCHES == 0
    ll_tabs, of_tabs, hdr, hdr_bits = (x.numpy() for x in got)
    assert ll_tabs.dtype == of_tabs.dtype == hdr_bits.dtype == np.int32
    assert hdr.shape == (len(cases), dt.HDR_CAP) and hdr.dtype == np.uint8
    for i, (llh, ofh) in enumerate(cases):
        w_ll, w_of, w_hdr, w_bits = _build_tables_py(
            llh.astype(np.uint32), ofh.astype(np.uint32), bool(finals[i]))
        assert np.array_equal(ll_tabs[i], w_ll.astype(np.int64)), i
        assert np.array_equal(of_tabs[i], w_of.astype(np.int64)), i
        assert int(hdr_bits[i]) == w_bits and len(w_hdr) == (w_bits + 7) // 8
        assert hdr[i, :len(w_hdr)].tobytes() == w_hdr, i
        assert not hdr[i, len(w_hdr):].any(), i
        assert hdr[i, 0] & 7 == (0b101 if finals[i] else 0b100)


def test_plain_keeps_the_device_and_checks_shapes():
    ll = torch.zeros((2, 288), dtype=torch.uint16)
    of = torch.zeros((2, 30), dtype=torch.uint16)
    finals = torch.tensor([False, True])
    out = dt.build_tables_plain(ll, of, finals)
    assert all(x.device == ll.device and x.shape[0] == 2 for x in out)
    with pytest.raises(ValueError):
        dt.build_tables(ll[:, :287], of, finals)
    with pytest.raises(ValueError):
        dt.build_tables(ll, of, finals[:1])
    empty = dt.build_tables(ll[:0], of[:0], finals[:0])
    assert [tuple(x.shape) for x in empty] == [(0, 288), (0, 30),
                                                (0, dt.HDR_CAP), (0,)]
