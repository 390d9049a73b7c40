#!/usr/bin/env python3
"""The emit kernel's own device time on its callers' main path shapes,
and how it compares with other builds of it: what `chip_smoke.py`'s
phase 28 (the kernel and its plain version by CUDA events, the bound)
does not report.

Usage: python3 scripts/emit_probe.py [--versus CSRC_DIR ...] [--out FILE]
       (from the root of a checkout; about a minute)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and takes the emit's inputs as the encode flows form them
(tests/_port_corpus.emit_pass_inputs): the L6 pass's 259 blocks (dynamic
mode, the bytes and distances column slices of the 98,304-position
windows), the L4 pass's 259 blocks (dynamic mode) and one L1 per-item
pass's 16 blocks (static mode). On each it holds the kernel
(`ops/emit.emit`) to its plain version on the card and gives the
kernel's device time by torch.profiler (the launch without the
wrapper's allocations and the state's clear) beside the bound
(chip_smoke.emit_bytes, counted from the pass's tokens).

With --versus, the emit kernel of other `csrc` directories (a `git
archive` of another commit's `libdeflate_rsx_tpu_torch/csrc`, unpacked
under build/) is compiled with the tree's flags into
`build/versus_emit/<k>/`, called through its own `ldrsx_emit` (the same
C interface), held equal to the tree's kernel and timed in turns with
it by CUDA events (each versus, tree, tree, each versus in reverse).
Every line names the card and its power limit and is copied to FILE
when given.
"""

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from _port_corpus import emit_pass_inputs  # noqa: E402

REPS = 10


def build_versus(dirs: list[str]) -> list:
    """Each directory's emit.cu compiled with the tree's flags and bound
    like the tree's library."""
    from libdeflate_rsx_tpu_torch.ops import _build, emit as em

    libs = []
    for k, d in enumerate(dirs):
        out = os.path.join(ROOT, "build", "versus_emit", str(k))
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, "emit.so")
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(d, "emit.cu")], check=True,
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        lib = ctypes.CDLL(so)
        ref = em._lib()
        lib.ldrsx_emit.argtypes = ref.ldrsx_emit.argtypes
        lib.ldrsx_emit.restype = ref.ldrsx_emit.restype
        lib.ldrsx_emit_scratch.argtypes = ref.ldrsx_emit_scratch.argtypes
        lib.ldrsx_emit_scratch.restype = ref.ldrsx_emit_scratch.restype
        libs.append((d, lib))
    return libs


@contextlib.contextmanager
def using(lib):
    """ops/emit.py's calls go to `lib` while open."""
    from libdeflate_rsx_tpu_torch.ops import emit as em

    old = em._lib
    em._lib = lambda: lib
    try:
        yield
    finally:
        em._lib = old


def device_ms(fn) -> float:
    """The emit kernel's own device time in ms, the mean of REPS calls
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "emit_kernel" in e.key)
    return us / 1e3 / REPS


def probe(say, versus_dirs) -> int:
    import torch
    from libdeflate_rsx_tpu_torch.ops import emit as em

    card = cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    sets = [(label, emit_pass_inputs(part, level, cs.SLICE, "cuda"))
            for label, part, level in (("the L6 pass", items, 6),
                                       ("the L4 pass", items, 4),
                                       ("an L1 pass", items[:1], 1))]
    versus = build_versus(versus_dirs)
    for label, (lanes, tables) in sets:
        b = lanes[1].shape[0]
        cs.emit_vs_plain(lanes, tables, label)

        def call():
            return em.emit(*lanes, *tables)
        bound = cs.emit_bytes(lanes, tables) / cs.HBM_BYTES_PER_MS
        say(f"emit on {label}'s {b} blocks: kernel {device_ms(call):.4f} "
            f"ms on the device (torch.profiler, {REPS} calls); bound "
            f"{bound:.6f} ms [{card}]")
        if not versus:
            continue
        want = call()
        for d, lib in versus:
            with using(lib):
                got = call()
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), d
        order = [*versus, (None, None), (None, None), *versus[::-1]]
        times = {}
        for d, lib in order:
            with using(lib) if lib is not None else contextlib.nullcontext():
                times.setdefault(d, []).append(cs.time_cuda(call, REPS))
        for d, ts in times.items():
            say(f"  {d or 'this tree'}: {', '.join(f'{t:.4f}' for t in ts)}"
                f" ms a call, in turns, equal outputs [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time in turns")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if f is not None:
                print(msg, file=f, flush=True)
        return probe(say, args.versus)


if __name__ == "__main__":
    sys.exit(main())
