"""State carried between the JAX package and the port.

There are no weights. What crosses is the pass-1 token layout (this
module) and the per-block code tables, which both packages' table steps
(`ops/encode_dynamic.build_tables_host`) give as the same numpy arrays.
"""

from __future__ import annotations

import numpy as np

from .ops.tokens import KIND_SHIFT

TOK_CHUNK = 256      # steps per token flush in the JAX pass-1 kernel


def from_jax_pass1(tokens, stats, n: int, s: int):
    """JAX pass-1 outputs -> the port's layout.

    tokens: (G, nflush, 256, s, 128) int32, one token per stream per
    step; stats: (G, 8, s, 128) int32 ([0] mode, [1] outlen, [3] bits
    consumed). n: number of streams in the batch.

    Returns (tokens (n, T) int32 with NOPs dropped and zeros after each
    stream's last token, stats (n, 4) int32 [mode, outlen, bits, ntokens],
    rows (n, 3) int64 of (group, sublane, lane) per stream index)."""
    tokens = np.asarray(tokens)
    stats = np.asarray(stats)
    g, nflush = tokens.shape[:2]
    lanes = s * 128
    cols = tokens.reshape(g, nflush * TOK_CHUNK, lanes)
    rows = np.zeros((n, 3), np.int64)
    kept = []
    out_stats = np.zeros((n, 4), np.int32)
    for i in range(n):
        gi, lane = divmod(i, lanes)
        si, li = divmod(lane, 128)
        rows[i] = (gi, si, li)
        col = cols[gi, :, lane]
        col = col[((col >> KIND_SHIFT) & 3) != 0]
        kept.append(col)
        out_stats[i] = (stats[gi, 0, si, li], stats[gi, 1, si, li],
                        stats[gi, 3, si, li], len(col))
    width = max([len(c) for c in kept] + [1])
    out = np.zeros((n, width), np.int32)
    for i, col in enumerate(kept):
        out[i, :len(col)] = col
    return out, out_stats, rows
