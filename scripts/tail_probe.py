#!/usr/bin/env python3
"""Where the compress tail's time goes on one CUDA card: the table step
(ops/dyn_tables.py) and the assembly (ops/assemble.py) on the main
path's inputs.

Usage: python3 scripts/tail_probe.py [--out FILE]

Inputs: the L6 pass of chip_smoke.py's corpus items (259 blocks, one
pass) and the L1 pass of its first item (16 blocks; the L1 tier runs one
such pass per item). For each call it prints
- the call's wall time, host clock, the card synchronised around it
  (what an encode flow's phase sees), mean of 20;
- the call's device time, CUDA events around 20 calls enqueued behind a
  device sleep, so the host's enqueue time is hidden;
- each kernel's device time per call by name (torch.profiler over 20
  calls), which splits the call into its own kernel and the copies and
  conversions around it.
Every line names the card. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def wall_ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / REPS


def device_ms(fn) -> float:
    """Device time per call: the calls are enqueued while the card sleeps,
    so no gap for the host's enqueue falls between the events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)          # ~30 ms at the card's clock
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def kernels_us(fn, tries: int = 3) -> list[tuple[str, float]]:
    """(name, device µs per call) of every device record over REPS calls:
    the mean of the launches recorded, times the launches a call
    (rounded, at least 1), so that launches the profiler drops do not
    lower it; profiled again, up to `tries` times, when a run records no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / e.count
                 * max(1, round(e.count / REPS)))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation and e.self_device_time_total > 0]
        if rows:
            break
    return sorted(rows, key=lambda r: -r[1])


def probe(say) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from libdeflate_rsx_tpu_torch.ops import assemble as asm
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dtab

    if not torch.cuda.is_available():
        print("tail_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    l6 = cs.device_pass(items, 6)
    l1 = cs.device_pass(items[:1], 1)
    calls = (
        ("dyn_tables, L6 pass (259 histograms)",
         lambda: dtab.build_tables(*l6["hist"])),
        ("assemble, L6 pass (259 blocks)", lambda: asm.assemble(*l6["inputs"])),
        ("assemble launch alone, L6 pass",
         lambda: asm.assemble_async(*l6["inputs"])),
        ("assemble, L1 pass of one item (16 blocks)",
         lambda: asm.assemble(*l1["inputs"])),
    )
    for name, fn in calls:
        say(f"{name}: wall {wall_ms(fn):.4f} ms, device {device_ms(fn):.4f} "
            f"ms per call [{card}]")
        for kernel, us in kernels_us(fn):
            say(f"  {us:9.2f} us  {kernel[:90]}")
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
