#!/usr/bin/env python3
"""Where the match kernels' time goes, on one CUDA card, and how they
compare with other designs of them.

Usage: python3 scripts/match_probe.py [--v2] [--versus CSRC_DIR ...]
       [--out FILE]      (from the root of a checkout; about a minute)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and takes the L6 pass's windows of its 1 MiB items (259 windows of
98,304 positions: the main path's shape). On those it holds the kernel
(`ops/match_l6.find_matches_l6`) to its plain version on the card,
times both by CUDA events beside the byte bound, and splits the
kernel's time into its stages: the kernel's C entry
`ldrsx_match_l6_stamped` has thread 0 of block 0 write the global
nanosecond timer at each stage end of its first window (STAGES), and the
stages of the mean of REPS calls are printed in microseconds, with the
sizes of that window's active lists (the grid positions whose group at
the level below has two or more members) and the launch shape: the
cluster size, the clusters resident at once and the rounds they take
over the windows.

With --versus, the match kernel of other `csrc` directories (a `git
archive` of the parent commit, say: `git archive HEAD
libdeflate_rsx_tpu_torch/csrc | tar -x -C build/parent`) is compiled
with the tree's flags into `build/versus_match/<k>/`, called through its
own `ldrsx_match_l6` (the cluster kernel's entry, or the one-block-per-
window kernel's of PR 11 with its global scratch), held equal to the
tree's kernel and timed in turns with it (each versus, tree, tree, each
versus in reverse), with its stages where its source has the stamped
entry.

With --v2, the same for the L1-5 match kernel (`csrc/match_v2.cu`,
`find_matches_v2` on the card) instead: held to its plain version and
timed beside it and the byte bound on the L4 pass's 259 blocks of
65,536 positions and on one L1 per-item pass's 16, with its launch
shape (cluster size, clusters resident, rounds) and the windows that
took its sort by the whole word; --versus then builds the `match_v2.cu`
of each directory and times it in turns with the tree's, held equal.
The stages of the first window of each library with the stamped entry
(`ldrsx_match_v2_stamped`, its stage names from
`ldrsx_match_v2_stage_names`) are printed in microseconds, mean of
REPS calls: for the sort by hash the TMA wait, each radix pass's rank,
local reorder, barrier, remote scatter and barrier, the neighbour
compare with its scatter by position, the walks, the word sort of an
escaped window and the output. Every line names the card and is copied
to FILE when given.
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
#: the cluster kernel's stages, in the order of its stamps 1..13 (stamp 0
#: is the window's start); after the stamps, the sizes of its active
#: lists (LISTS)
STAGES = ("load", "base sort", "base sweep", "even list", "8-byte sort",
          "8-byte sweep", "L16 sort", "L16 sweep", "L32 sort", "L32 sweep",
          "L64 sort", "L64 sweep", "decay")
LISTS = ("8-byte", "L16", "L32", "L64")
#: the stages of PR 11's one-block-per-window kernel
BLOCK_STAGES = ("load", "base sort", "base sweep", "8-byte sort",
                "8-byte sweep", "L16 sort", "L16 sweep", "L32 sort",
                "L32 sweep", "L64 sort", "L64 sweep", "decay")


def bind(lib) -> dict:
    """ctypes signatures of a match_l6 library: {"cluster": whether it is
    the cluster kernel (else PR 11's, with global scratch), "stamped":
    whether it has the stamped entry, "stages": its stage names}."""
    p, i = ctypes.c_void_p, ctypes.c_int
    cluster = hasattr(lib, "ldrsx_match_l6_shape")
    if cluster:
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ldrsx_match_l6_shape.argtypes = [i, ip, ip, ip]
        lib.ldrsx_match_l6_shape.restype = i
        lib.ldrsx_match_l6.argtypes = [p, i, i, i, p, p, p, p, p]
    else:
        lib.ldrsx_match_l6_scratch.argtypes = [i]
        lib.ldrsx_match_l6_scratch.restype = ctypes.c_longlong
        lib.ldrsx_match_l6.argtypes = [p, i, i, i, p, p, p, i, p, p, p]
    lib.ldrsx_match_l6.restype = i
    stamped = hasattr(lib, "ldrsx_match_l6_stamped")
    if stamped:
        fn = lib.ldrsx_match_l6_stamped
        fn.argtypes = list(lib.ldrsx_match_l6.argtypes)[:-1] + [p, p]
        fn.restype = i
    return {"cluster": cluster, "stamped": stamped,
            "stages": STAGES if cluster else BLOCK_STAGES}


def caller(lib, kind: dict):
    """find_matches_l6-like callable through a library's C entry; with
    stamps= (a CUDA int64 tensor of len(stages) + 1, and len(LISTS) more
    for the cluster kernel) the stamped entry."""
    import torch

    def call(rows, valid, hist, s, stamps=None):
        b = rows.shape[0]
        dev = rows.device
        ml = torch.empty((b, s), dtype=torch.int64, device=dev)
        dist = torch.empty((b, s), dtype=torch.int64, device=dev)
        valid32, hist32 = valid.to(torch.int32), hist.to(torch.int32)
        args = [rows.data_ptr(), b, rows.shape[1], s, valid32.data_ptr(),
                hist32.data_ptr()]
        if not kind["cluster"]:
            blocks = min(b, torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
            scratch = torch.empty(blocks * lib.ldrsx_match_l6_scratch(s),
                                  dtype=torch.int64, device=dev)
            args += [scratch.data_ptr(), blocks]
        args += [ml.data_ptr(), dist.data_ptr()]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stamps is not None and kind["stamped"]:
            rc = lib.ldrsx_match_l6_stamped(*args, stamps.data_ptr(), stream)
        else:
            rc = lib.ldrsx_match_l6(*args, stream)
        if rc != 0:
            raise RuntimeError(f"match_l6 failed: CUDA error {rc}")
        return ml, dist
    return call


def v2_caller(lib):
    """find_matches_v2-like callable (rows, valid, s) through a match_v2
    library's C entry; with stamps= (a CUDA int64 tensor of one more word
    than its stages) the stamped entry. Its `stages` attribute holds the
    library's stage names, or None where it has no stamped entry."""
    import torch
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ldrsx_match_v2.argtypes = [p, i, i, i, p, p, p, p]
    lib.ldrsx_match_v2.restype = i
    names = None
    if hasattr(lib, "ldrsx_match_v2_stamped"):
        lib.ldrsx_match_v2_stamped.argtypes = [p, i, i, i, p, p, p, p, p]
        lib.ldrsx_match_v2_stamped.restype = i
        lib.ldrsx_match_v2_stage_names.restype = ctypes.c_char_p
        names = tuple(lib.ldrsx_match_v2_stage_names().decode().split(","))

    def call(rows, valid, s, stamps=None):
        b, dev = rows.shape[0], rows.device
        ml = torch.empty((b, s), dtype=torch.int64, device=dev)
        dist = torch.empty((b, s), dtype=torch.int64, device=dev)
        valid32 = valid.to(torch.int32)
        args = [rows.data_ptr(), b, rows.shape[1], s, valid32.data_ptr(),
                ml.data_ptr(), dist.data_ptr()]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stamps is not None:
            rc = lib.ldrsx_match_v2_stamped(*args, stamps.data_ptr(), stream)
        else:
            rc = lib.ldrsx_match_v2(*args, stream)
        if rc != 0:
            raise RuntimeError(f"match_v2 failed: CUDA error {rc}")
        return ml, dist
    call.stages = names
    return call


def build_versus(dirs: list[str], name: str = "match_l6") -> list:
    """For each csrc directory, its <name>.cu compiled with the tree's
    flags into build/versus_<name>/<k>/ (one nvcc each, all started
    together): [(label, library)]."""
    from libdeflate_rsx_tpu_torch.ops import _build
    jobs = []
    for k, csrc in enumerate(dirs):
        out = os.path.join(ROOT, "build", f"versus_{name}", str(k))
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, f"{name}.so")
        jobs.append((k, csrc, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    found = []
    for k, csrc, so, p in jobs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{err}")
        found.append((f"versus {k} ({csrc})", ctypes.CDLL(so)))
    return found


def in_turns(runs: dict, reps: int) -> dict:
    """CUDA-event ms of each run, in turns: each versus, the tree twice,
    each versus in reverse."""
    others = [k for k in runs if k != "tree"]
    t = {k: [] for k in runs}
    for k in others + ["tree", "tree"] + others[::-1]:
        t[k].append(cs.time_cuda(runs[k], reps))
    return t


def stages(fn, args, names, cluster: bool) -> str:
    """The stages of fn's first window, mean of REPS calls, in µs; for
    the cluster kernel, the window's active list sizes."""
    import torch
    stamps = torch.zeros((REPS, len(names) + 1 + len(LISTS)),
                         dtype=torch.int64, device="cuda")
    for r in range(REPS):
        fn(*args, stamps=stamps[r])
    torch.cuda.synchronize()
    t = stamps[:, :len(names) + 1]
    us = (t[:, 1:] - t[:, :-1]).double().mean(0).cpu() / 1e3
    line = ", ".join(f"{name} {x:.1f}" for name, x in zip(names, us)) \
        + f"; window {float(us.sum()):.1f} us"
    if cluster:
        sizes = stamps[0, len(names) + 1:].tolist()
        line += "; active lists " + ", ".join(
            f"{n} {v}" for n, v in zip(LISTS, sizes)) \
            + f" of {args[3] // 2} grid positions"
    return line


def v2_stages(fn, args) -> str:
    """The stages of the match_v2 kernel's first window (block 0 of the
    first cluster), mean of REPS calls, in µs."""
    import torch
    names = fn.stages
    stamps = torch.zeros((REPS, len(names) + 1), dtype=torch.int64,
                         device="cuda")
    for r in range(REPS):
        fn(*args, stamps=stamps[r])
    torch.cuda.synchronize()
    us = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).cpu() / 1e3
    return ", ".join(f"{name} {x:.1f}" for name, x in zip(names, us)) \
        + f"; window {float(us.sum()):.1f} us"


def probe(say, versus_dirs) -> int:
    import torch
    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import \
        find_matches_l6_plain

    if not torch.cuda.is_available():
        print("match_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    lib = _build.load("match_l6")
    tree = caller(lib, bind(lib))
    versus = []
    for label, vlib in build_versus(versus_dirs):
        kind = bind(vlib)
        versus.append({"label": label, "fn": caller(vlib, kind), **kind})
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    rows, valid, hist, s = cs.l6_windows_of(items, cs.SLICE)
    args = (rows, valid, hist, s)
    cs.match_vs_plain(*args, "the corpus windows")
    mine = tree(*args)
    runs = {"tree": lambda: tree(*args)}
    for v in versus:
        got = v["fn"](*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(mine, got)), \
            f"tree != {v['label']}"
        runs[v["label"]] = (lambda fn: lambda: fn(*args))(v["fn"])
    t = in_turns(runs, REPS)
    plain = cs.time_cuda(lambda: find_matches_l6_plain(*args), 3)
    b = rows.shape[0]
    nbytes = rows.numel() + 8 * b + 16 * b * s
    say(f"match_l6 on the {b} L6 windows of the corpus (s = {s}): "
        + "; ".join(f"{k} " + " / ".join(f"{x:.3f}" for x in v)
                    for k, v in t.items())
        + f" ms per call (CUDA events, {REPS} calls each, in turns); plain "
        f"version {plain:.3f} ms on the card; bound "
        f"{nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes) [{card}]")
    from libdeflate_rsx_tpu_torch.ops.match_l6 import launch_shape
    size, smem, clusters = launch_shape(s)
    say(f"  tree launch: clusters of {size} blocks ({smem} B of shared "
        f"memory each), {clusters} resident at once, "
        f"{-(-b // clusters)} rounds over the {b} windows")
    say(f"  tree stages: {stages(tree, args, STAGES, True)}")
    for v in versus:
        if v["stamped"]:
            say(f"  {v['label']} stages: "
                f"{stages(v['fn'], args, v['stages'], v['cluster'])}")
    return 0


def probe_v2(say, versus_dirs) -> int:
    import torch
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import find_matches_v2_plain
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops.match_v2 import launch_shape

    if not torch.cuda.is_available():
        print("match_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    tree = v2_caller(_build.load("match_v2"))
    versus = [(label, v2_caller(lib))
              for label, lib in build_versus(versus_dirs, "match_v2")]
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    s = cs.SLICE
    _, arr, valid, _, _ = gd.split_many(items, s, False)
    arr1, valid1, _, _ = gs.split_blocks(items[0], s)
    for label, (rows, v) in (("the L4 pass", (arr, valid)),
                             ("an L1 pass", (arr1, valid1))):
        args = (torch.from_numpy(rows).cuda(), torch.from_numpy(v).cuda(), s)
        cs.v2_vs_plain(*args, label)
        mine = tree(*args)
        runs = {"tree": lambda: tree(*args)}
        for vlabel, fn in versus:
            got = fn(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(mine, got)), \
                f"tree != {vlabel}"
            runs[vlabel] = (lambda f: lambda: f(*args))(fn)
        t = in_turns(runs, REPS)
        plain = cs.time_cuda(lambda: find_matches_v2_plain(*args), 3)
        b = rows.shape[0]
        nbytes = cs.v2_bytes(rows, s)
        say(f"match_v2 on {label}'s {b} blocks (s = {s}): "
            + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                        for k, v in t.items())
            + f" ms per call (CUDA events, {REPS} calls each, in turns); "
            f"plain version {plain:.3f} ms on the card; bound "
            f"{nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes) [{card}]")
        size, smem, clusters, rounds = launch_shape(s, b)
        mv2.reset_escapes()
        tree(*args)
        say(f"  tree launch: clusters of {size} blocks ({smem} B of shared "
            f"memory each), {clusters} resident at once, {rounds} rounds "
            f"over the {b} windows; {mv2.escapes()} windows sorted by the "
            f"whole word")
        for vlabel, fn in [("tree", tree)] + versus:
            if fn.stages is not None:
                say(f"  {vlabel} stages: {v2_stages(fn, args)}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time against")
    ap.add_argument("--v2", action="store_true",
                    help="probe the L1-5 match kernel (match_v2)")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return (probe_v2 if args.v2 else probe)(say, args.versus)


if __name__ == "__main__":
    sys.exit(main())
