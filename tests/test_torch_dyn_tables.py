"""The device table step (ops/dyn_tables.py) on the CPU.

1. A Python mirror of the CUDA kernel's package-merge (csrc/dyn_tables.cu:
   the leaves as packed (frequency << 9 | symbol) keys, sorted; every
   level merged by 32 lanes, each from its merge-path split, with the
   packages keyed by (weight, first symbol); a bit mask of the leaves
   among each level's items; each symbol's length counted from the
   selected prefix of every level) against the port's
   `length_limited_lengths`, which sorts whole (weight, symbols) tuples,
   on seeded histograms with many ties, at the widths and limits the
   kernel runs (19 precode symbols at 7 bits, 30 offsets at 15, 288
   litlen symbols at 14) and the others of those.
2. The plain version `build_tables_plain` against the JAX package's
   `_build_tables_py` (the builder it runs while its native codec does
   not build) on random and edge histograms: tables, header bytes and
   header bits.
3. A Python mirror of the kernel's parallel header pass (run starts,
   each run's precode symbols in closed form, their places by an
   exclusive scan, canonical codes from per-length counts and ranks,
   each field's bit offset by an exclusive scan, ORed into 32-bit
   words) against the JAX package's `_precode_rle` and the header that
   the plain version writes, on seeded tie-heavy (litlen, offset)
   histogram pairs and edge cases.

Tolerance: exact equality (integers and bytes). The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import itertools

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.models.portable.deflate import (
    _ensure_complete,
    _precode_rle,
)
from libdeflate_rsx_tpu.models.portable.huffman import canonical_codes
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
    keys = sorted(f << 9 | s for s, f in enumerate(freqs) if f)
    n = len(keys)
    if n <= 1:
        for k in keys:
            lens[k & 511] = 1
        return lens

    def leaf_first(key, w, f):
        return key <= (w << 9 | f)

    w, f = [k >> 9 for k in keys], [k & 511 for k in keys]
    masks, cnt = [(1 << n) - 1], n
    for _ in range(1, max_len):
        npk = cnt // 2
        m = n + npk
        pw = [w[2 * p] + w[2 * p + 1] for p in range(npk)]
        pf = [f[2 * p] for p in range(npk)]
        assert max(pw, default=0) < 1 << 25           # 32-bit weights
        w, f, mask = [0] * m, [0] * m, 0
        for lane in range(32):
            d0, d1 = (m * lane) >> 5, (m * (lane + 1)) >> 5
            lo, hi = max(0, d0 - npk), min(d0, n)
            while lo < hi:                            # the merge-path split
                mid = (lo + hi) >> 1
                p = d0 - 1 - mid
                if leaf_first(keys[mid], pw[p], pf[p]):
                    lo = mid + 1
                else:
                    hi = mid
            i, p = lo, d0 - lo
            for d in range(d0, d1):
                if p >= npk or (i < n and leaf_first(keys[i], pw[p], pf[p])):
                    w[d], f[d] = keys[i] >> 9, keys[i] & 511
                    mask |= 1 << d
                    i += 1
                else:
                    w[d], f[d] = pw[p], pf[p]
                    p += 1
        masks.append(mask)
        cnt = m
    c = min(2 * n - 2, cnt)
    takes = [0] * max_len
    for k in reversed(range(max_len)):
        takes[k] = bin(masks[k] & ((1 << c) - 1)).count("1")
        c = 2 * (c - takes[k])
    for i, k in enumerate(keys):
        lens[k & 511] = sum(i < t for t in takes)
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


PERM = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
EXTRA_BITS = {16: 2, 17: 3, 18: 7}


def run_symbols(v: int, length: int) -> list[tuple[int, int]]:
    """The kernel's closed form of one maximal run's precode symbols
    (symbol, extra value)."""
    if v == 0:
        q, r = divmod(length, 138)
        out = [(18, 127)] * q
        if r >= 11:
            out.append((18, r - 11))
            r = 0
        if r >= 3:
            out.append((17, r - 3))
            r = 0
        return out + [(0, 0)] * r
    q, r = divmod(length - 1, 6)
    out = [(v, 0)] + [(16, 3)] * q
    if r >= 3:
        out.append((16, r - 3))
        r = 0
    return out + [(v, 0)] * r


def canonical_mirror(lens) -> list[int]:
    """The kernel's canonical codes: per-length counts, each symbol's
    rank among its length a prefix count, next_code as a closed-form
    scan, bit-reversed."""
    count = [0] * 16
    rank = []
    for sym_len in lens:
        rank.append(count[sym_len])
        count[sym_len] += 1
    next_code = [sum(count[j] << (ln - j) for j in range(1, ln))
                 for ln in range(16)]
    return [int(format(next_code[ln] + r, f"0{ln}b")[::-1], 2) if ln else 0
            for ln, r in zip(lens, rank)]


def header_mirror(ll_lens, of_lens, final: bool):
    """The kernel's header pass in Python: (the run-length symbols and
    extras, header bytes, header bits)."""
    ll_lens, of_lens = list(ll_lens), list(of_lens)
    num_ll = max(257, max(i for i, x in enumerate(ll_lens) if x) + 1)
    num_of = max(1, max((i + 1 for i, x in enumerate(of_lens) if x),
                        default=1))
    lens = ll_lens[:num_ll] + of_lens[:num_of]
    starts = [i for i in range(len(lens)) if i == 0 or lens[i] != lens[i - 1]]
    runs = [(lens[a], b - a) for a, b in zip(starts, starts[1:] + [len(lens)])]
    counts = [len(run_symbols(*r)) for r in runs]
    places = [sum(counts[:k]) for k in range(len(runs))]       # the scan
    syms = [None] * sum(counts)
    for at, run in zip(places, runs):
        for k, sym in enumerate(run_symbols(*run)):
            syms[at + k] = sym
    pre_freq = [0] * 19
    for sym, _ in syms:
        pre_freq[sym] += 1
    pre_lens = [int(x) for x in _ensure_complete(
        np.array(merge_lengths(pre_freq, 7)))]
    pre_codes = canonical_mirror(pre_lens)
    assert pre_codes == canonical_codes(np.array(pre_lens)).tolist()
    nexp = max(4, max((i + 1 for i in range(19) if pre_lens[PERM[i]]),
                      default=0))
    fields = [((1 if final else 0) | 4 | (num_ll - 257) << 3
               | (num_of - 1) << 8 | (nexp - 4) << 13, 17)]
    fields += [(pre_lens[PERM[i]], 3) for i in range(nexp)]
    fields += [(pre_codes[sym] | ev << pre_lens[sym],
                pre_lens[sym] + EXTRA_BITS.get(sym, 0)) for sym, ev in syms]
    words = [0] * (dt.HDR_CAP // 4)
    bit = 0
    for value, width in fields:                 # offsets: the scan
        assert value < 1 << width
        words[bit >> 5] |= (value << (bit & 31)) & 0xFFFFFFFF
        if (bit & 31) + width > 32:
            words[(bit >> 5) + 1] |= value >> (32 - (bit & 31))
        bit += width
    hdr = b"".join(x.to_bytes(4, "little") for x in words)
    return syms, hdr, bit


def header_pairs():
    """(ll_hist, of_hist) pairs: tie-heavy histograms at widths 288 and
    30, the edge pairs, one used symbol, all 288 used, and zero runs
    past 138."""
    lls = tie_histograms(288, 14, 300, seed=9)
    ofs = tie_histograms(30, 15, 300, seed=10)
    pairs = list(zip(lls, ofs)) + edge_histograms()
    z_ll, z_of = np.zeros(288, np.int64), np.zeros(30, np.int64)
    for used in ([0], [0, 200], [5, 150, 287], [140, 283]):
        ll = z_ll.copy()
        ll[used] = 3
        pairs += [(ll, z_of), (ll, np.ones(30, np.int64))]
    return pairs


def test_header_mirror_equals_precode_rle_and_the_plain_header():
    pairs = header_pairs()
    ll = torch.from_numpy(np.stack([p[0] for p in pairs])).to(torch.uint16)
    of = torch.from_numpy(np.stack([p[1] for p in pairs])).to(torch.uint16)
    finals = torch.from_numpy(np.arange(len(pairs)) % 2 == 1)
    ll_tabs, of_tabs, hdr, hdr_bits = dt.build_tables_plain(ll, of, finals)
    long_zero = 0
    for i, (llh, ofh) in enumerate(pairs):
        llf = llh.copy()
        llf[256] += 1
        ll_lens = (ll_tabs[i] >> 16).tolist()
        of_lens = (of_tabs[i] >> 16).tolist()
        assert ll_lens == list(_ensure_complete(np.array(
            merge_lengths(llf, 14)))), i
        assert of_lens == list(_ensure_complete(np.array(
            merge_lengths(ofh, 15)))), i
        assert canonical_mirror(ll_lens) == (ll_tabs[i] & 0xFFFF).tolist()
        syms, got, bits = header_mirror(ll_lens, of_lens, bool(finals[i]))
        num_ll = max(257, max(j for j, x in enumerate(ll_lens) if x) + 1)
        num_of = max(1, max((j + 1 for j, x in enumerate(of_lens) if x),
                            default=1))
        want = _precode_rle(np.array(ll_lens[:num_ll] + of_lens[:num_of]))
        assert [s for s, _ in syms] == want[0].tolist(), i
        assert [e for _, e in syms] == want[1].tolist(), i
        assert [EXTRA_BITS.get(s, 0) for s, _ in syms] == want[2].tolist()
        long_zero += any(s == 18 and e == 127 for s, e in syms)
        assert bits == int(hdr_bits[i]), i
        assert got == hdr[i].numpy().tobytes(), i
    assert long_zero >= 4                   # zero runs past 138 were met
