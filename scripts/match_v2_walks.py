#!/usr/bin/env python3
"""How long the L1-5 match kernel's walks through a hash bucket get on the
Silesia-like corpus, counted on the CPU (no device time).

Usage: python3 scripts/match_v2_walks.py [--block 65536]

The kernel (`csrc/match_v2.cu`) sorts a window's positions stably by a
16-bit hash of their word; a position whose sorted neighbour is another
word of the same hash walks back through its bucket to the first equal
word. For each block of the corpus (cut as `chip_smoke.py` cuts it into
items and blocks), this prints the longest walk counted two ways: in
single positions passed (a walk that steps one element at a time) and in
runs of one word passed (the kernel's walk, which skips a run of equal
words in one step along a bitmap of the word boundaries), and how many
blocks have a walk of 32 or more and of WALK_CAP or more of each (a
walk that reaches WALK_CAP runs sends its window to the kernel's sort by
the whole word).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd  # noqa: E402
from libdeflate_rsx_tpu_torch.ops.match_v2 import (HASH_MUL,  # noqa: E402
                                                   REACH, WALK_CAP)


def longest_walks(row, n: int) -> tuple[int, int]:
    """(positions, runs) the longest walk of a window of n positions
    passes before it stops at an equal word, the bucket's start or a
    position more than REACH back."""
    w = row[:n + 3].astype(np.int64)
    word = w[:n] | w[1:n + 1] << 8 | w[2:n + 2] << 16 | w[3:n + 3] << 24
    h = ((word * HASH_MUL) & 0xFFFFFFFF) >> 16
    order = np.argsort(h, kind="stable")
    ws, hs = word[order], h[order]
    edge = np.ones(n, bool)
    edge[1:] = ws[1:] != ws[:-1]
    start = np.maximum.accumulate(np.where(edge, np.arange(n), 0))
    out = []
    for by_runs in (False, True):
        idx = np.arange(1, n)
        j = idx - 1
        passed = np.zeros(n - 1, np.int64)
        live = np.ones(n - 1, bool)
        while live.any():
            a = np.nonzero(live)[0]
            ii, jj = idx[a], j[a]
            go = (ws[jj] != ws[ii]) & (hs[jj] == hs[ii]) \
                & (order[ii] - order[jj] <= REACH)
            passed[a[go]] += 1
            live[a[~go]] = False
            nxt = (start[jj[go]] if by_runs else jj[go]) - 1
            j[a[go]] = nxt
            live[a[go][nxt < 0]] = False
        out.append(int(passed.max(initial=0)))
    return out[0], out[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--block", type=int, default=cs.SLICE)
    args = ap.parse_args()
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    _, arr, _, _, _ = gd.split_many(items, args.block, False)
    walks = np.array([longest_walks(arr[i], args.block)
                      for i in range(arr.shape[0])])
    for k, name in enumerate(("positions", "runs")):
        col = walks[:, k]
        print(f"longest walk in {name} over {len(col)} blocks of "
              f"{args.block} bytes: max {col.max()}; 32 or more in "
              f"{(col >= 32).sum()} blocks, {WALK_CAP} or more in "
              f"{(col >= WALK_CAP).sum()} (counted on the CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
