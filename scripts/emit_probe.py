#!/usr/bin/env python3
"""The emit kernel's own device time on its callers' main path shapes,
its launch shape and stage split, and how it compares with other builds
of it: what `chip_smoke.py`'s phase 28 (the kernel and its plain version
by CUDA events, the bound) does not report.

Usage: python3 scripts/emit_probe.py [--versus CSRC_DIR ...] [--ablate]
       [--out FILE] (from the root of a checkout; one to three minutes)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and takes the emit's inputs as the encode flows form them
(tests/_port_corpus.emit_pass_inputs): the L6 pass's 259 blocks (dynamic
mode, the bytes and distances column slices of the 98,304-position
windows), the L4 pass's 259 blocks (dynamic mode) and one L1 per-item
pass's 16 blocks (static mode). On each it holds the kernel
(`ops/emit.emit`) to its plain version on the card and prints:
- the launch shape (lanes a tile, blocks, blocks resident an SM,
  registers, shared memory; `emit.launch_shape`);
- the kernel's device time by torch.profiler (the mean over the
  launches it recorded) beside the bound
  (chip_smoke.emit_bytes, counted from the pass's tokens);
- the stage split of block 0's tiles (the C entry `ldrsx_emit_shaped`
  called with a stamps buffer, which launches the kernel's stamped
  instance: clock64 cycles of its thread 0 in each stage, a tile on
  average, and in microseconds by the tiles' globaltimer);
- at the L1 pass, the wrapper's host time a call (the host clock around
  each of 200 calls, the card idle before each) beside the C call's
  alone.

With --ablate, copies of the tree's emit.cu with one stage cut each
(ABLATIONS: the coding, the match loop alone, the (ml, dist) gathers,
the packing and store, the store alone, the look-back's wait) are built
into `build/ablate_emit/<name>/` and their device times on the L6 and
L1 passes taken in turns with the tree's (torch.profiler): what each
stage costs under the full load, which block 0's stamps (one thread's
view) do not show. Their outputs are not held equal. Each cut is an
exact line of emit.cu, asserted to be found once, so an edit of those
lines stops --ablate with the line it no longer finds: update ABLATIONS
with the kernel.

With --versus, the emit kernel of other `csrc` directories (a `git
archive` of another commit's `libdeflate_rsx_tpu_torch/csrc`, unpacked
under build/) is compiled with the tree's flags into
`build/versus_emit/<k>/` and called through its own `ldrsx_emit`, whose
arguments every design keeps, on the same inputs (rows that the first
design's 8- and 16-byte loads take, copied before timing where the
flow's are not) with a state buffer of its own; it is held equal to the
tree's kernel and timed in turns with it (each versus, tree, tree, each
versus in reverse): CUDA events around REPS calls of the C entry, and
each kernel's device time by torch.profiler. Every line names the card
and its power limit and is copied to FILE when given.
"""

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
from _port_corpus import emit_pass_inputs  # noqa: E402

REPS = 10
HOST_CALLS = 200
#: the stages cut out of copies of csrc/emit.cu by --ablate: each is a
#: list of (text, its replacement), every text found once
ABLATIONS = {
    "no coding": [("      code_tile<DYN>(a, sh, j,",
                   "      if (0) code_tile<DYN>(a, sh, j,")],
    "no match loop": [("  for (int xx = lane; xx < pre[K]; xx += 32) {",
                       "  for (int xx = lane; xx < 0; xx += 32) {")],
    "no gathers": [("      gather<DYN>(a, sh, j + 1);",
                    "      if (0) gather<DYN>(a, sh, j + 1);")],
    "no packing or store": [
        ("      pack_tile<DYN>(a, sh, pbi,",
         "      if (0) pack_tile<DYN>(a, sh, pbi,"),
        ("      store_tile<DYN>(a, sh, pbi,",
         "      if (0) store_tile<DYN>(a, sh, pbi,")],
    "no store": [("      store_tile<DYN>(a, sh, pbi,",
                  "      if (0) store_tile<DYN>(a, sh, pbi,")],
    "no look-back wait": [
        ("        const long long base = look_back(status, pk);",
         "        const long long base = 0;")],
}


def compile_emit(src: str, out: str):
    """emit.cu text compiled with the tree's flags into out/emit.so, bound
    like the tree's library (ldrsx_emit, ldrsx_emit_scratch)."""
    from libdeflate_rsx_tpu_torch.ops import _build, emit as em

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "emit.cu"), "w") as f:
        f.write(src)
    so = os.path.join(out, "emit.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                    os.path.join(out, "emit.cu")], check=True,
                   stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    lib = ctypes.CDLL(so)
    ref = em._lib()
    for fn in ("ldrsx_emit", "ldrsx_emit_scratch"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return lib


def build_ablations() -> list:
    """(name, library) of each ABLATIONS copy of the tree's emit.cu."""
    from libdeflate_rsx_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, "emit.cu")) as f:
        src = f.read()
    libs = []
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        out = os.path.join(ROOT, "build", "ablate_emit",
                           name.replace(" ", "_"))
        libs.append((name, compile_emit(text, out)))
    return libs


def ablate(say, sets, card: str) -> None:
    """Device time of each ablated copy beside the tree's, in turns."""
    from libdeflate_rsx_tpu_torch.ops import emit as em

    libs = build_ablations()
    for label, (lanes, tables) in sets:
        if label == "the L4 pass":
            continue
        runs = [("this tree", raw_call(em._lib(), lanes, tables))]
        runs += [(n, raw_call(lib, lanes, tables)) for n, lib in libs]
        times = {}
        for n, fn in [*runs, *runs[::-1]]:
            times.setdefault(n, []).append(device_ms(fn))
        for n, ts in times.items():
            say(f"  {label}, {n}: {', '.join(f'{t:.4f}' for t in ts)} ms "
                f"on the device (torch.profiler, in turns) [{card}]")


def build_versus(dirs: list[str]) -> list:
    """Each directory's emit.cu compiled with the tree's flags, its
    ldrsx_emit and ldrsx_emit_scratch bound as the tree's."""
    libs = []
    for k, d in enumerate(dirs):
        with open(os.path.join(d, "emit.cu")) as f:
            src = f.read()
        out = os.path.join(ROOT, "build", "versus_emit", str(k))
        libs.append((d, compile_emit(src, out)))
    return libs


def raw_call(lib, lanes, tables, stamps=None):
    """A function that runs lib's ldrsx_emit on these inputs into outputs
    and a zeroed state of its own, made once (the first design clears its
    state itself, the present one leaves it zeroed). Its lanes are the
    inputs with rows on the first design's load widths. With stamps (an
    int64 CUDA tensor, one word a stage name), the tree's
    ldrsx_emit_shaped instead, rounding the copies as ops/emit.emit does,
    and block 0's stage times into stamps."""
    import torch
    from libdeflate_rsx_tpu_torch.ops.emit import (ROW, ROW_OUT, ROW_OUT_DYN,
                                                   _round_ok)

    data, ml, dist, sel, lit, s = lanes
    b, r, dyn = ml.shape[0], s // ROW, bool(tables)

    def on(x, align):
        return x if x.data_ptr() % align == 0 and \
            x.stride(0) * x.element_size() % align == 0 else x.contiguous()
    ml, dist, sel, lit = on(ml, 16), on(dist, 16), on(sel, 8), on(lit, 8)
    dev = ml.device
    rows = torch.empty((b, r, (ROW_OUT_DYN if dyn else ROW_OUT) + 1),
                       dtype=torch.uint8, device=dev)
    words = torch.empty((3, b, r), dtype=torch.int64, device=dev)
    end = torch.empty(b, dtype=torch.int64, device=dev)
    state = torch.zeros(lib.ldrsx_emit_scratch(b, r), dtype=torch.uint8,
                        device=dev)
    start = tables[2].to(torch.int64).contiguous() if dyn else \
        torch.full((b,), 3, dtype=torch.int64, device=dev)
    tabs = [t.to(torch.int32).contiguous() for t in tables[:2]]
    stream = torch.cuda.current_stream().cuda_stream
    rnd = _round_ok(sel, s) | _round_ok(lit, s) << 1 | _round_ok(data, s) << 2

    def call():
        ll, of = (tabs[0].data_ptr(), tabs[1].data_ptr()) if dyn else \
            (None, None)
        args = (data.data_ptr(), data.stride(0), ml.data_ptr(),
                ml.stride(0), dist.data_ptr(), dist.stride(0), sel.data_ptr(),
                sel.stride(0), lit.data_ptr(), lit.stride(0), ll, of,
                start.data_ptr(), b, r, rows.data_ptr(), words[0].data_ptr(),
                words[1].data_ptr(), end.data_ptr(), state.data_ptr())
        if stamps is None:
            rc = lib.ldrsx_emit(*args, stream)
        else:
            rc = lib.ldrsx_emit_shaped(*args, rnd, stamps.data_ptr(), stream)
        assert rc == 0, rc
        return rows, words[0], words[1], end
    return call


def device_ms(fn) -> float:
    """The emit kernel's own device time in ms: the mean over the launches
    that torch.profiler recorded of REPS calls (a capture that recorded
    none is taken again, up to three times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        got = [(e.device_time_total, e.count) for e in prof.key_averages()
               if "emit_kernel" in e.key]
        n = sum(c for _, c in got)
        if n:
            return sum(t for t, _ in got) / n / 1e3
    return float("nan")


def stage_split(say, lanes, tables, label: str, card: str) -> None:
    """Block 0's tiles' stages, a tile on average."""
    import ctypes as ct

    import torch
    from libdeflate_rsx_tpu_torch.ops import emit as em

    lib = em._lib()
    lib.ldrsx_emit_stage_names.restype = ct.c_char_p
    names = lib.ldrsx_emit_stage_names().decode().split(",")
    st = torch.zeros(len(names), dtype=torch.int64, device="cuda")
    want = em.emit(*lanes, *tables)
    got = raw_call(lib, lanes, tables, stamps=st)()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    v = dict(zip(names, st.tolist()))
    n = max(v["tiles"], 1)
    ns = v["tile ns"] / max(v["tile cycles"], 1)
    parts = ", ".join(f"{k} {v[k] / n:.0f} ({v[k] / n * ns / 1e3:.2f} us)"
                      for k in names[:8])
    say(f"  stages of block 0's {v['tiles']} tiles on {label}, cycles a "
        f"tile (clock64 of thread 0; {ns:.3f} ns a cycle by globaltimer): "
        f"{parts}; a tile {v['tile cycles'] / n:.0f} cycles, "
        f"{v['tile ns'] / n / 1e3:.2f} us [{card}]")


def host_time(say, lanes, tables, card: str) -> None:
    """The wrapper's host time a call and the C call's alone: the host
    clock around each of HOST_CALLS calls, the card idle before each (so
    no call waits on a full launch queue)."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import emit as em

    raw = raw_call(em._lib(), lanes, tables)
    for label, fn in (("emit (the wrapper)", lambda: em.emit(*lanes,
                                                             *tables)),
                      ("the C call alone", raw)):
        fn()
        total = 0.0
        for _ in range(HOST_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        say(f"  {label}: {total / HOST_CALLS * 1e3:.4f} ms of host time a "
            f"call (mean of {HOST_CALLS}, the card idle before each) "
            f"[{card}]")


def probe(say, versus_dirs, ablations: bool = False) -> int:
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
        b, s = lanes[1].shape[0], lanes[5]
        cs.emit_vs_plain(lanes, tables, label)
        shape = em.launch_shape(b, s, bool(tables))
        say(f"emit on {label}'s {b} blocks: launch {shape} [{card}]")

        def call():
            return em.emit(*lanes, *tables)
        bound = cs.emit_bytes(lanes, tables) / cs.HBM_BYTES_PER_MS
        say(f"  kernel {device_ms(call):.4f} ms on the device "
            f"(torch.profiler, {REPS} calls); bound {bound:.6f} ms [{card}]")
        stage_split(say, lanes, tables, label, card)
        say(f"  emit {cs.time_cuda(call, REPS):.4f} ms a call (CUDA events, "
            f"{REPS} calls) [{card}]")
        if not tables:
            host_time(say, lanes, tables, card)
        if not versus:
            continue
        want = call()
        runs = [(d, raw_call(lib, lanes, tables)) for d, lib in versus]
        mine = raw_call(em._lib(), lanes, tables)
        for d, fn in runs:
            got = fn()
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), d
        order = [*runs, (None, mine), (None, mine), *runs[::-1]]
        times, dev = {}, {}
        for d, fn in order:
            times.setdefault(d, []).append(cs.time_cuda(fn, REPS))
            dev.setdefault(d, []).append(device_ms(fn))
        for d in times:
            ev = ", ".join(f"{t:.4f}" for t in times[d])
            say(f"  {d or 'this tree'}: {ev} ms a call (CUDA events), "
                f"{', '.join(f'{t:.4f}' for t in dev[d])} ms on the device "
                f"(torch.profiler), in turns, equal outputs [{card}]")
    if ablations:
        ablate(say, sets, card)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time in turns")
    ap.add_argument("--ablate", action="store_true",
                    help="time copies of the kernel with a stage cut")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        f = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if f is not None:
                print(msg, file=f, flush=True)
        return probe(say, args.versus, args.ablate)


if __name__ == "__main__":
    sys.exit(main())
