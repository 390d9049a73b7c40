#!/usr/bin/env python3
"""Where the select kernel's time goes, on one CUDA card, and how it
compares with other designs of it.

Usage: python3 scripts/select_probe.py [--versus CSRC_DIR ...] [--out FILE]
       (from the root of a checkout; about a minute)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and takes the select kernel's inputs on its three callers' main
path shapes: the L6 pass's 259 windows of 98,304 positions (the match
kernel's (ml, dist), cells of 256, outputs from the 32 KiB history,
histograms), one L1 per-item pass's 16 windows of 65,536 positions
(find_matches_v2, cells of 64, no histograms) and the L4 pass's 259
windows (cells of 64, histograms). On each it holds the kernel
(`ops/select.select`) to its plain version on the card, times both by
CUDA events beside the byte bound (the (ml, dist) int64 and the data
bytes in, ml int64, sel and lit out, once each), and splits the kernel's
time into its stages: the C entry `ldrsx_select_stamped` has one thread
of the block of the first tile (ticket 0, in the launch's first wave)
and of the tile halfway through the launch (every SM busy) write the
global nanosecond timer at each stage end (the mean of REPS calls, in
microseconds). A block-per-window kernel with such an entry (PR 13's
design, stamped) reports its first window's stages summed over its
tiles instead (WINDOW_STAGES).

With --versus, the select kernel of other `csrc` directories (a `git
archive` of the parent commit, say: `git archive HEAD
libdeflate_rsx_tpu_torch/csrc | tar -x -C build/parent`) is compiled
with the tree's flags into `build/versus_select/<k>/`, called through
its own `ldrsx_select` (the tiled kernel's entry, with its scan state,
or the block-per-window kernel's, with its uint16 scratch row), held
equal to the tree's kernel and timed in turns with it (each versus,
tree, tree, each versus in reverse), with its stages where its source
has the stamped entry. Every line names the card and its power limit
and is copied to FILE when given.
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

REPS = 10
#: the block-per-window kernel's stages (summed over a window's 16 tiles,
#: kept for a stamped build of that design)
WINDOW_STAGES = ("pass-1 loads", "pass-1 scan", "pass-2 loads",
                 "three prefix maxima", "ml_short next_bit", "walk",
                 "outputs and atomics")
#: the tiled kernel's stages (one tile)
TILE_STAGES = ("ticket", "loads", "run extension", "run starts",
               "look-back", "raw and selected ends", "cells", "walk",
               "outputs", "histogram counts", "histogram sums")


def bind(lib) -> dict:
    """ctypes signatures of a select library: {"tiled": whether it is the
    tiled kernel (else the block-per-window kernel with its scratch row),
    "stamped": whether it has the stamped entry, "stages": their names}."""
    p, i = ctypes.c_void_p, ctypes.c_int
    tiled = hasattr(lib, "ldrsx_select_scratch")
    args = [p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p, p, p, p, p, p,
            p]
    lib.ldrsx_select.argtypes = args
    lib.ldrsx_select.restype = i
    if tiled:
        lib.ldrsx_select_scratch.argtypes = [i, i, i, i]
        lib.ldrsx_select_scratch.restype = ctypes.c_longlong
    stamped = hasattr(lib, "ldrsx_select_stamped")
    if stamped:
        lib.ldrsx_select_stamped.argtypes = args[:-1] + [p, p]
        lib.ldrsx_select_stamped.restype = i
    return {"tiled": tiled, "stamped": stamped,
            "stages": TILE_STAGES if tiled else WINDOW_STAGES}


def caller(lib, kind: dict):
    """select-like callable through a library's C entry: (ml, dist,
    valid, data, l6[, stamps]) -> the kernel's outputs (ml, sel, lit[,
    ll, of]); with stamps (a CUDA int64 tensor) the stamped entry."""
    import torch
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import HIST, WTILE_L6
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import WTILE

    def call(ml, dist, valid, data, l6, stamps=None):
        start, wtile = (HIST, WTILE_L6) if l6 else (0, WTILE)
        b, s = ml.shape
        n = s - start
        dev = ml.device
        valid32 = valid.to(torch.int32)
        out = [torch.empty((b, n), dtype=torch.int64, device=dev),
               torch.empty((b, n), dtype=torch.bool, device=dev),
               torch.empty((b, n), dtype=torch.bool, device=dev)]
        if data is not None:
            out += [torch.empty((b, 288), dtype=torch.uint16, device=dev),
                    torch.empty((b, 30), dtype=torch.uint16, device=dev)]
        if kind["tiled"]:
            nbytes = lib.ldrsx_select_scratch(b, s, start,
                                              int(data is not None))
        else:
            nbytes = 2 * b * n
        scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                              device=dev)
        args = [ml.data_ptr(), dist.data_ptr(), valid32.data_ptr(),
                None if data is None else data.data_ptr(),
                0 if data is None else data.shape[1], b, s, start, wtile,
                int(l6), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(),
                None if data is None else out[3].data_ptr(),
                None if data is None else out[4].data_ptr(),
                scratch.data_ptr()]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stamps is not None and kind["stamped"]:
            rc = lib.ldrsx_select_stamped(*args, stamps.data_ptr(), stream)
        else:
            rc = lib.ldrsx_select(*args, stream)
        if rc != 0:
            raise RuntimeError(f"select failed: CUDA error {rc}")
        return out
    return call


def build_versus(dirs: list[str]) -> list[dict]:
    """For each csrc directory, its select.cu compiled with the tree's
    flags into build/versus_select/<k>/ (one nvcc each, all started
    together): [{"label", "fn", "stamped", "stages"}]."""
    from libdeflate_rsx_tpu_torch.ops import _build
    jobs = []
    for k, csrc in enumerate(dirs):
        out = os.path.join(ROOT, "build", "versus_select", str(k))
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, "select.so")
        jobs.append((k, csrc, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, "select.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    found = []
    for k, csrc, so, p in jobs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{err}")
        lib = ctypes.CDLL(so)
        kind = bind(lib)
        found.append({"label": f"versus {k} ({csrc})",
                      "fn": caller(lib, kind), **kind})
    return found


def stages(fn, args, names) -> list[str]:
    """The stamped blocks' stages, mean of REPS calls, in µs: the
    block-per-window kernel's first window (its tiles summed), or the
    tiled kernel's first tile and the tile halfway through the launch."""
    import torch
    n = len(names) + 1
    stamps = torch.zeros((REPS, 2 * n), dtype=torch.int64, device="cuda")
    for r in range(REPS):
        fn(*args, stamps=stamps[r])
    torch.cuda.synchronize()
    if names is WINDOW_STAGES:
        rows = [("first window", stamps[:, :len(names)].double())]
    else:                            # the timer at each stage end
        rows = [(label, (stamps[:, k + 1:k + n] - stamps[:, k:k + n - 1])
                 .double()) for label, k in (("first tile", 0),
                                             ("middle tile", n))]
    out = []
    for label, t in rows:
        us = t.mean(0).cpu() / 1e3
        out.append(f"{label}: " + ", ".join(
            f"{name} {x:.2f}" for name, x in zip(names, us))
            + f"; in all {float(us.sum()):.2f} us")
    return out


def inputs(items):
    """The select kernel's inputs on its three callers' main path shapes:
    [(label, (ml, dist, valid, data or None, l6))], on the card."""
    import torch
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import find_matches_v2

    rows, valid, hist, s = cs.l6_windows_of(items, cs.SLICE)
    l6 = (*ml6.find_matches_l6(rows, valid, hist, s), valid.long(), rows,
          True)
    arr, valid1, _, _ = gs.split_blocks(items[0], cs.SLICE)
    arr, valid1 = torch.from_numpy(arr).cuda(), \
        torch.from_numpy(valid1).cuda().long()
    l1 = (*find_matches_v2(arr, valid1, cs.SLICE), valid1, None, False)
    _, arr4, valid4, _, _ = gd.split_many(items, cs.SLICE, False)
    arr4, valid4 = torch.from_numpy(arr4).cuda(), \
        torch.from_numpy(valid4).cuda().long()
    l4 = (*find_matches_v2(arr4, valid4, cs.SLICE), valid4, arr4, False)
    return [(f"the L6 pass's {rows.shape[0]} windows", l6),
            (f"an L1 pass's {arr.shape[0]} windows", l1),
            (f"the L4 pass's {arr4.shape[0]} windows", l4)]


def bound_bytes(ml, data, l6) -> int:
    """Bytes the function must move: per payload position (ml, dist)
    int64 and its byte (with histograms) in, ml int64, sel and lit out;
    per window valid_len in and the histograms out."""
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import HIST
    b, s = ml.shape
    n = s - (HIST if l6 else 0)
    hist = data is not None
    return b * n * (8 + 8 + hist + 8 + 1 + 1) + b * (8 + hist * 2 * 318)


def probe(say, versus_dirs) -> int:
    import torch
    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import select as sl

    if not torch.cuda.is_available():
        print("select_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    lib = _build.load("select")
    kind = bind(lib)
    tree = caller(lib, kind)
    versus = build_versus(versus_dirs)
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    for label, args in inputs(items):
        ml, dist, valid, rows, l6 = args
        cs.select_vs_plain(*args, label)
        mine = tree(*args)
        runs = {"tree": lambda: tree(*args)}
        for v in versus:
            got = v["fn"](*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(mine, got)), \
                f"tree != {v['label']} on {label}"
            runs[v["label"]] = (lambda fn: lambda: fn(*args))(v["fn"])
        others = [k for k in runs if k != "tree"]
        t = {k: [] for k in runs}
        for k in others + ["tree", "tree"] + others[::-1]:
            t[k].append(cs.time_cuda(runs[k], REPS))
        wrapper = cs.time_cuda(lambda: sl.select(*args[:4], l6=l6), REPS)
        plain = cs.time_cuda(lambda: sl.select_plain(*args[:4], l6=l6), 3)
        nbytes = bound_bytes(ml, rows, l6)
        say(f"select on {label} (s = {ml.shape[1]}): "
            + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                        for k, v in t.items())
            + f" ms per call (CUDA events, {REPS} calls each, in turns); "
            f"ops/select.select {wrapper:.4f} ms; plain version "
            f"{plain:.3f} ms on the card; bound "
            f"{nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes) "
            f"[{card}]")
        for label, fn, k in [("tree", tree, kind)] + [
                (v["label"], v["fn"], v) for v in versus]:
            if k["stamped"]:
                for line in stages(fn, args, k["stages"]):
                    say(f"  {label} stages, {line} [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time against")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say, args.versus)


if __name__ == "__main__":
    sys.exit(main())
