"""Memory budget of one device pass.

A batch whose work would not fit on the card at once is split into
device passes whose estimated peak stays under a budget: the dynamic
compress tiers split at block boundaries (each block row carries its own
history prefix, so rows are independent), the static tier likewise, and
the two-pass decoder at stream boundaries. Bytes do not depend on the
split. A unit (one row, one stream) whose estimate alone passes the
budget gets a pass of its own.

The estimate of a unit is PEAK_PER_BYTE[kind] times its size: the bytes
of its block row (`arr.shape[1]`: the block, its match padding and, at
L6, the 32 KiB history prefix) for a compress tier, max(out_cap, input
bytes) for a decode stream. The coefficients are the one-pass peaks
that `chip_smoke.py` (phase 18) measures on an H100 with
`torch.cuda.max_memory_allocated`, rounded up; phase 18 fails if a
measured peak passes them.

The budget is LIMIT when it is set (tests shrink it), else on a CUDA
device FREE_SHARE of the memory the card and PyTorch's caching
allocator can still give, divided among the SHARERS ranks that plan
passes on the same card at once (`parallel.multihost.initialize` counts
them); on the CPU there is no bound unless LIMIT is set.
"""

from __future__ import annotations

import collections

import torch

#: bytes one device pass may hold at its peak; None: from the device
LIMIT: int | None = None
#: share of the card's free memory one pass may take
FREE_SHARE = 0.8
#: ranks that run passes on this process's card at the same time
SHARERS = 1
#: peak device bytes of one pass per byte of a unit's size (module
#: docstring). chip_smoke.py phase 18 measured 171.8, 278.1 and 240.9
#: for the compress tiers on the corpus (NVIDIA H100 80GB HBM3, 700 W),
#: each rounded up by a quarter to a multiple of 8, then 192.3 at L6 once
#: the match finder ran as a kernel (ops/match_l6.py; 700.00 W), rounded
#: likewise, then 189.3 at L6, 279.2 at levels 4-5 and 172.5 at levels
#: 1-3 once the selection ran as a kernel (ops/select.py; 700.00 W),
#: then 23.65 at L6 and 91.73 at levels 1-5 once the emit ran as a
#: kernel (ops/emit.py; 700.00 W), then 26.93 at levels 1-3 and 26.96
#: at 4-5 once the L1-5 match finder ran as a kernel (ops/match_v2.py;
#: 700.00 W: its plain sort had set those peaks), each rounded likewise,
#: and 9.37 for the two-pass decode with
#: the resolve kernel on the L6 items (7.00 on the 64 KiB slices, phase
#: 20; NVIDIA H100 80GB HBM3, 700.00 W), rounded up by a half (a stored
#: stream's input, as long as its output, adds pass-1 scratch that the
#: L6 items lack)
PEAK_PER_BYTE = {
    "static": 40,      # levels 1-3: per byte of a block row
    "dynamic": 40,     # levels 4-5 and the sharded dynamic tier
    "l6": 32,          # levels 6-9: per byte of a row with its history
    "decode": 15,      # two-pass decode: per max(out_cap, input) byte
}
#: device passes run, by kind
PASSES: collections.Counter = collections.Counter()


def limit(device) -> int | None:
    """Bytes one pass may use on `device`, or None for no bound."""
    if LIMIT is not None:
        return LIMIT
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)
    return int(FREE_SHARE * (free + cached) / SHARERS)


def estimate(kind: str, sizes) -> int:
    """Estimated one-pass peak of units of these sizes, in bytes."""
    return PEAK_PER_BYTE[kind] * int(sum(sizes))


def passes(kind: str, sizes, device) -> list[tuple[int, int]]:
    """Split units 0..n-1 (in order, of these sizes) into consecutive
    passes [lo, hi) whose estimate stays under the budget; a unit over
    it alone gets a pass of its own. Counts the passes in PASSES."""
    sizes = [int(s) for s in sizes]
    cap = limit(device)
    if cap is None:
        out = [(0, len(sizes))] if sizes else []
    else:
        out, lo, held = [], 0, 0
        for i, s in enumerate(sizes):
            cost = PEAK_PER_BYTE[kind] * s
            if i > lo and held + cost > cap:
                out.append((lo, i))
                lo, held = i, 0
            held += cost
        if sizes:
            out.append((lo, len(sizes)))
    PASSES[kind] += len(out)
    return out
