#!/usr/bin/env python3
"""Where the resolve kernel's time goes, on one CUDA card.

Usage: python3 scripts/resolve_probe.py [--out FILE]
       (from the root of a checkout; about a minute)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and runs pass 1 on the main path's two decode sets (the 17 L6
items at the 1 MiB out_cap, the 256 zlib-6 slices at 64 KiB). On their
tokens, and on four hand-built patterns of 256 columns of 64 KiB each
(all literals; a dist-1 run of 258-byte matches; matches of 8 bytes
reaching 1,000-4,000 bytes back, which a lane copies alone; matches of
8 bytes at distance 4, each waiting for the one before), it times the
resolve kernel and its plain version by CUDA events and splits the
kernel's call into its five kernels with torch.profiler. Every result
is held to the plain version first. Each line is printed, and copied to
FILE when given.
"""

import argparse
import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402

REPS = 5
N_COLS = 256
CAP = 65536


def patterns():
    """{name: (columns, out_cap)}: the four hand-built patterns."""
    import numpy as np
    from _port_corpus import col, lit, match

    rng = np.random.default_rng(1)
    head = [lit(int(x)) for x in rng.integers(0, 256, 4096)]
    toks = {
        "literals": [lit(int(x)) for x in rng.integers(0, 256, CAP)],
        "dist-1 run": [lit(7)] + [match(258, 1)] * ((CAP - 1) // 258),
        "solo matches": head + [match(8, int(d)) for d in
                                rng.integers(1000, 4000, (CAP - 4096) // 8)],
        "chained matches": [lit(1), lit(2), lit(3), lit(4)]
        + [match(8, 4)] * ((CAP - 4) // 8),
    }
    return {k: ([col(t, len(t))] * N_COLS, CAP) for k, t in toks.items()}


def split(tok, cap: int) -> dict:
    """Device microseconds of each kernel of one resolve call, the mean
    of REPS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            rs.resolve_batch(tok, cap)
        torch.cuda.synchronize()
    return {e.key.split("::")[-1].split("(")[0]: e.self_device_time_total
            / REPS for e in prof.key_averages()
            if e.self_device_time_total > 0}


def probe(say) -> int:
    import numpy as np
    import torch
    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    if not torch.cuda.is_available():
        print("resolve_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    comp = BatchCompressor(level=6, use_device=True,
                           device="cuda").compress_batch(items)
    slices = [cs.raw_z(data[i * cs.SLICE:(i + 1) * cs.SLICE])
              for i in range(cs.N_SLICES)]
    sets = {}
    for name, streams, cap in (("17 L6 items", comp, cs.ITEM),
                               ("256 zlib-6 slices", slices, cs.SLICE)):
        tok, stats = cs.pass1_columns(streams, cap)
        sets[name] = (tok, cap, int(stats[:, 3].sum()))
    for name, (cols, cap) in patterns().items():
        tok = torch.from_numpy(np.stack(cols)).cuda()
        sets[name] = (tok, cap, tok.shape[0] * tok.shape[1])
    for name, (tok, cap, ntok) in sets.items():
        cs.resolve_vs_plain(tok, cap, name)
        ms = cs.time_cuda(lambda: rs.resolve_batch(tok, cap), REPS)
        plain = cs.time_cuda(lambda: rs.resolve_batch_plain(tok, cap), REPS)
        parts = split(tok, cap)
        say(f"resolve {name}: {tok.shape[0]} columns, {ntok} tokens; "
            f"kernel {ms:.3f} ms, plain version {plain:.3f} ms (CUDA "
            f"events, {REPS} calls each); " + ", ".join(
                f"{k} {v:.1f} us" for k, v in sorted(parts.items()))
            + f" [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say)


if __name__ == "__main__":
    sys.exit(main())
