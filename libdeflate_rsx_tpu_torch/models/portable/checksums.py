"""Host checksum kernels (numpy-vectorized).

The analog of the reference's scalar/SIMD checksum tiers (reference
src/crc32/mod.rs slice-8, src/adler32/mod.rs chunked scalar): here the
parallel axis is "many equal-length chunks processed in lockstep numpy
lanes", folded with the associative combine operators from
ops/checksum_math.py. The TPU MXU kernels live in ops/checksums.py.
"""

from __future__ import annotations

import numpy as np

from ...ops.checksum_math import (
    ADLER_MOD,
    CRC_TABLE,
    crc32_shift_operator,
    mat_apply,
)

_VEC_THRESHOLD = 1 << 12  # below this, the serial loop is faster
_NUM_LANES = 1024


def crc32_host(data: bytes, crc: int = 0) -> int:
    """CRC-32 (gzip) of data, continuing from `crc`."""
    reg = np.uint32(crc ^ 0xFFFFFFFF)
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    pos = 0
    if n >= _VEC_THRESHOLD:
        lanes = _NUM_LANES
        lane_len = n // lanes
        main = lanes * lane_len
        chunks = arr[:main].reshape(lanes, lane_len)
        regs = np.zeros(lanes, dtype=np.uint32)
        # all lanes advance one byte per iteration (SIMD-across-chunks)
        for k in range(lane_len):
            regs = CRC_TABLE[(regs ^ chunks[:, k]) & np.uint32(0xFF)] ^ (
                regs >> np.uint32(8))
        # Tree-reduce the per-lane registers pairwise (lanes is a power of
        # two, so every round is uniform-length): combined = shift(left,
        # right_len) ^ right. Keeps the serial part O(log lanes).
        fold_regs = regs
        fold_len = lane_len
        while len(fold_regs) > 1:
            half_op = crc32_shift_operator(fold_len)
            even = fold_regs[0::2]
            odd = fold_regs[1::2]
            if len(even) > len(odd):
                merged = np.concatenate(
                    [mat_apply(half_op, even[:len(odd)]) ^ odd, even[-1:]])
            else:
                merged = mat_apply(half_op, even) ^ odd
            fold_regs = merged
            fold_len *= 2
        op_all = crc32_shift_operator(main)
        reg = mat_apply(op_all, reg) ^ fold_regs[0]
        pos = main
    for b in arr[pos:]:
        reg = CRC_TABLE[(reg ^ b) & np.uint32(0xFF)] ^ (reg >> np.uint32(8))
    return int(reg ^ np.uint32(0xFFFFFFFF))


def adler32_host(data: bytes, adler: int = 1) -> int:
    """Adler-32 (zlib) of data, continuing from `adler`."""
    n = len(data)
    s1 = adler & 0xFFFF
    s2 = (adler >> 16) & 0xFFFF
    if n == 0:
        return ((s2 << 16) | s1) & 0xFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    total = int(arr.sum())
    # s2 accumulates s1 after every byte: s2 += n*s1_0 + sum_i (n-i)*d[i]
    weighted = int(np.dot(arr, np.arange(n, 0, -1, dtype=np.int64)))
    s2 = (s2 + n * s1 + weighted) % ADLER_MOD
    s1 = (s1 + total) % ADLER_MOD
    return ((s2 << 16) | s1) & 0xFFFFFFFF
