"""Canonical length-limited Huffman code construction (host engine).

The reference builds codes with a counting-sort + in-place tree + depth
redistribution pipeline (reference src/compress/huffman_comp.rs:8-155). We
instead use the boundary package-merge algorithm, which yields *optimal*
length-limited codes (never worse than depth-redistribution) in O(n·L) — a
deliberate design difference that helps meet the "compressed size ≤
reference" bar. Codeword assignment is canonical with bit-reversed output,
as required for DEFLATE's LSB-first wire format.
"""

from __future__ import annotations

import numpy as np

from ...utils.bits import reverse_bits


def length_limited_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal code lengths (≤ max_len) for the given symbol frequencies.

    Symbols with zero frequency get length 0. A single used symbol gets
    length 1 (DEFLATE cannot express 0-bit codes).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    lens = np.zeros(len(freqs), dtype=np.int32)
    active = np.nonzero(freqs)[0]
    n = len(active)
    if n == 0:
        return lens
    if n == 1:
        lens[active[0]] = 1
        return lens
    if n > (1 << max_len):
        raise ValueError("too many symbols for codeword length limit")

    leaves = sorted((int(freqs[s]), (int(s),)) for s in active)
    items = list(leaves)
    for _ in range(max_len - 1):
        pkgs = [
            (items[i][0] + items[i + 1][0], items[i][1] + items[i + 1][1])
            for i in range(0, len(items) - 1, 2)
        ]
        items = sorted(leaves + pkgs)
    for _, syms in items[: 2 * n - 2]:
        for s in syms:
            lens[s] += 1
    return lens


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Assign canonical codewords (already bit-reversed for LSB-first emit)."""
    lens = np.asarray(lens, dtype=np.int32)
    max_len = int(lens.max(initial=0))
    codes = np.zeros(len(lens), dtype=np.uint32)
    if max_len == 0:
        return codes
    counts = np.bincount(lens, minlength=max_len + 1)
    counts[0] = 0
    next_code = np.zeros(max_len + 1, dtype=np.int64)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code
    order = np.argsort(lens, kind="stable")
    for sym in order:
        l = int(lens[sym])
        if l == 0:
            continue
        codes[sym] = reverse_bits(int(next_code[l]), l)
        next_code[l] += 1
    return codes


def make_huffman_code(freqs: np.ndarray, max_len: int):
    """Frequencies -> (lengths, bit-reversed canonical codewords)."""
    lens = length_limited_lengths(freqs, max_len)
    return lens, canonical_codes(lens)
