#!/usr/bin/env python3
"""Where the device checksums' time goes on one CUDA card
(ops/checksums.py over csrc/checksums.cu).

Usage: python3 scripts/checksum_probe.py [--out FILE] [--versus DIR ...]
                                         [--ablate DIR ...] [--ablate-adler]
                                         [--record-versus ROOT ...]
                                         [--turns N]

Inputs: chip_smoke.py's corpus (16,936,000 bytes) as the sharded static
tier hands it over, 259 zero-padded rows of 64 KiB with int32 lengths
(and again with int64 lengths, which skip the wrapper's conversion, and
with every length 65,536, which leaves no short span), and as one
buffer, and as the compress items' 17 rows of 1 MiB (the last one
short). For crc32_blocks, adler32_blocks, crc32_fixed and
adler32_fixed it prints
- the call's wall time, host clock, the card synchronised around it;
- the call's device time, CUDA events around calls enqueued behind a
  device sleep, so the host's enqueue time is hidden (the inputs warm
  in L2 from the call before);
- each kernel's device time per call by name (torch.profiler), which
  also counts the kernels a call launches;
then the walls of the first and second crc32_device and adler32_device
call of the corpus in a fresh process (the kernels already built), the
copy to the card included, and the CRC kernel's registers and spills
(nvcc's -Xptxas -v report). Then the stage split of block 0 of the
CRC blocks call (clock64() stamps, a build with -DLDRSX_STAGES): the
table build, and a step's hashing, fold to the row and finish; and of
block 0 of the Adler calls (the 259 rows, the buffer, the 17 rows of
1 MiB) where the source has the tile design (adler_kernel): a tile's
loads, group sums, the block's sums, the atomics and the finish. With
--versus, builds of the checksums.cu in each DIR (another version of
the source: `git archive HEAD libdeflate_rsx_tpu_torch/csrc | tar -x
-C build/parent` gives the parent's) are timed in turns with the
default build (default, versions, versions, default, --turns times) on
the blocks calls (the 259 rows; Adler also the 17 rows of 1 MiB) and
the buffer calls, with L2 warm and again flushed before each call
(the CRC's buffer warm only), each held equal to the default, with
each Adler call's kernels by name (torch.profiler); and the stage
split is taken of each DIR's kernel too, where its source has the
CRC's block-a-row design (stamps put into a copy: block 0 is row 0,
its start, its tables, its spans, its fold). --ablate DIR builds (copies of the source with a
stage cut out, whose results are wrong) are timed in the same turns,
unchecked, with their stage splits; --ablate-adler adds copies of the
default source without the Adler kernel's loads, without its group
sums, without both, and without its shuffles. --record-versus ROOT
(another checkout of the repo: `git archive HEAD | tar -x -C
build/parent-tree` gives the parent's) times chip_smoke.py's checksums
record, crc32_blocks and adler32_blocks on the 259 rows with int32
lengths, as its phase 30 does (CUDA events around 5 calls enqueued by
the host, no device sleep, so the wrappers' host time counts), through
this tree's package and each ROOT's, each in its own process, in turns
(tree, roots, roots reversed, tree, --turns times): the median, least
and most of SAMPLES such timings a process; beside each, on the host
clock, the wrapper's time a call with the card not waited on, the bare
C entry's (the launch alone) and a yardstick (`lengths.to(int64)`, one
PyTorch op) that shows how fast the process's host runs. Every line
names the card.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FIRST_CALLS = """
import sys, time
sys.path.insert(0, {root!r})
import chip_smoke as cs
from libdeflate_rsx_tpu_torch.ops import checksums as ck
data = cs.corpus()
for name, fn in (("crc32_device", ck.crc32_device),
                 ("adler32_device", ck.adler32_device)):
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        fn(data)
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"{{name}} of the corpus in a fresh process: first call "
          f"{{walls[0]:.2f}} ms, second {{walls[1]:.2f}} ms (host clock)")
print(f"host tables built: {{ck._crc_byte_table.cache_info().currsize}}")
"""

#: timings of the smoke's checksums record a process (--record-versus)
SAMPLES = 40

RECORD = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np, torch
from libdeflate_rsx_tpu_torch.ops import checksums as ck
assert ck.__file__.startswith({root!r}), ck.__file__
z = np.load({npz!r})
rows = torch.from_numpy(z["rows"]).cuda()
n32 = torch.from_numpy(z["n32"]).cuda()
want = {{"crc32_blocks": z["crc"], "adler32_blocks": z["adler"]}}


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


entry = ck._kernel("ldrsx_checksum_rows")
n64 = n32.to(torch.int64)
out = torch.empty(len(n32), dtype=torch.int64, device="cuda")
head = (rows.data_ptr(), rows.stride(0), rows.shape[0], rows.shape[1],
        n64.data_ptr())
tail = (out.data_ptr(), torch.cuda.current_stream().cuda_stream)
extra = (None,) * (len(entry.argtypes) - 8)   # the scratch pointer, if any
fns = {{"crc32_blocks": ck.crc32_blocks, "adler32_blocks": ck.adler32_blocks}}
for kind, (name, fn) in enumerate(fns.items()):
    assert np.array_equal(fn(rows, n32).cpu().numpy(), want[name]), name
    assert entry(kind, *head, *extra, *tail) == 0, name
    assert np.array_equal(out.cpu().numpy(), want[name]), name
got = {{name + k: [] for name in fns for k in ("", " host", " C entry")}}
got["yardstick"] = []
for _ in range({samples}):
    for kind, (name, fn) in enumerate(fns.items()):
        got[name].append(time_cuda(lambda: fn(rows, n32), 5))
        got[name + " host"].append(host_us(lambda: fn(rows, n32), 5))
        got[name + " C entry"].append(
            host_us(lambda: entry(kind, *head, *extra, *tail), 5))
    got["yardstick"].append(host_us(lambda: n32.to(torch.int64), 5))
print(json.dumps(got))
"""

#: clock64() stamps put into a copy of PR 19's source: block 0 (row 0)
#: at its start, after its tables, after every thread's span (a barrier
#: added), after the fold
OLD_STAMPS = (
    ("namespace {\n",
     "namespace {\n__device__ long long g_stages[64];\n"
     "#define STAMP(k) if (KIND == CRC && blockIdx.x == 0 && "
     "threadIdx.x == 0) g_stages[k] = clock64();\n"),
    ("  const int64_t row = blockIdx.x;\n",
     "  const int64_t row = blockIdx.x;\n  STAMP(0)\n"),
    ("  const int64_t span = (width + ROW_THREADS - 1) / ROW_THREADS;\n",
     "  STAMP(1)\n"
     "  const int64_t span = (width + ROW_THREADS - 1) / ROW_THREADS;\n"),
    ("  p = block_fold<KIND, ROW_THREADS>(p, warps);\n",
     "  if (KIND == CRC) __syncthreads();\n  STAMP(2)\n"
     "  p = block_fold<KIND, ROW_THREADS>(p, warps);\n  STAMP(3)\n"),
)
STAGES_ENTRY = """
extern "C" int ldrsx_checksum_stages(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_stages, sizeof(long long) * 64));
}
"""


#: cut-down copies of the Adler kernel (--ablate-adler): (name,
#: [(text, replacement)]), whose results are wrong
ADLER_LOADS = ("      v[k] = o + GROUP <= len ? load_group<ALIGNED>(p + o)\n"
               "                              : make_uint4(0, 0, 0, 0);\n")
ADLER_SUMS = ("      r += s1;\n      s1 = group_a(v[k], s1);\n"
              "      w = group_w(v[k], w);\n")
ADLER_SHUFFLES = ("#pragma unroll\n    for (int off = 16; off; off >>= 1) {\n"
                  "      av += __shfl_xor_sync(0xFFFFFFFFu, av, off);\n"
                  "      b += __shfl_xor_sync(0xFFFFFFFFu, b, off);\n    }\n")
NO_LOADS = (ADLER_LOADS, "      v[k] = make_uint4(o, len, k, t);\n")
NO_SUMS = (ADLER_SUMS, "      r ^= v[k].x;\n      s1 ^= v[k].y;\n"
                       "      w ^= v[k].z ^ v[k].w;\n")
ADLER_ABLATIONS = (("no-adler-loads", [NO_LOADS]),
                   ("no-adler-sums", [NO_SUMS]),
                   ("no-adler-loads-sums", [NO_LOADS, NO_SUMS]),
                   ("no-adler-shuffles", [(ADLER_SHUFFLES, "")]))


def is_new(source: str) -> bool:
    """Whether a checksums.cu has this tree's CRC design (crc_kernel)."""
    return "crc_kernel" in open(source).read()


def adler_is_new(source: str) -> bool:
    """Whether a checksums.cu has this tree's Adler design (adler_kernel,
    whose rows entry takes a scratch pointer)."""
    return "adler_kernel" in open(source).read()


def adler_ablations(own: str) -> list[str]:
    """Directories under build/ holding the ADLER_ABLATIONS copies of
    the source `own`."""
    from libdeflate_rsx_tpu_torch.ops import _build

    text = open(own).read()
    dirs = []
    for name, cuts in ADLER_ABLATIONS:
        cut = text
        for old, new in cuts:
            assert cut.count(old) == 1, (name, old)
            cut = cut.replace(old, new)
        d = os.path.join(os.path.dirname(_build.BUILD_DIR), name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "checksums.cu"), "w") as f:
            f.write(cut)
        dirs.append(d)
    return dirs


def variant(source: str, tag: str, stages: bool = False):
    """A build of `source` under build/kernels/, loaded; with stages, a
    build that records block 0's clock64() stamps (PR 19's source gets
    them put into a copy)."""
    from libdeflate_rsx_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    flags = list(_build.NVCC_FLAGS)
    if stages:
        flags.append("-DLDRSX_STAGES")
        if not is_new(source):
            text = open(source).read()
            for old, new in OLD_STAMPS:
                assert text.count(old) == 1, old
                text = text.replace(old, new)
            source = os.path.join(_build.BUILD_DIR, f"checksums-{tag}.cu")
            with open(source, "w") as f:
                f.write(text + STAGES_ENTRY)
    so = os.path.join(_build.BUILD_DIR, f"checksums-{tag}.so")
    subprocess.run([_build.nvcc(), *flags, "-o", so, source], check=True,
                   capture_output=True)
    return ctypes.CDLL(so)


class Build:
    """One build of checksums.cu: its rows entry through the dispatchers
    (a rows entry without the scratch pointer, an older source's, bound
    as it was), its buffer entry with the scratch its design takes (a
    zeroed state of the build's own in this tree's designs, else a row
    register a row)."""

    def __init__(self, label: str, lib, new: bool, adler_new: bool = True):
        self.label, self.lib, self.new = label, lib, new
        self.adler_new = adler_new
        self.states = {}

    def entry(self, name: str):
        import ctypes as c

        from libdeflate_rsx_tpu_torch.ops import checksums as ck
        if self.adler_new or name != "ldrsx_checksum_rows":
            return ck._bind(self.lib, name)
        fn = getattr(self.lib, name)
        fn.argtypes = [c.c_int, c.c_void_p, c.c_int64, c.c_int64,
                       c.c_int64] + [c.c_void_p] * 3
        fn.restype = c.c_int
        return lambda kind, data, stride, rows, width, lengths, scratch, \
            out, stream: fn(kind, data, stride, rows, width, lengths, out,
                            stream)

    def rows(self, fn, rows, lengths):
        from libdeflate_rsx_tpu_torch.ops import checksums as ck
        default = ck._kernel
        ck._kernel = self.entry
        try:
            return fn(rows, lengths)
        finally:
            ck._kernel = default

    def buffer(self, kind: int, buf, n: int, init: int, scratch):
        import torch

        from libdeflate_rsx_tpu_torch.ops import checksums as ck
        out = torch.empty((), dtype=torch.int64, device=buf.device)
        if (self.new and kind == 0) or (self.adler_new and kind == 1):
            if kind not in self.states:
                self.states[kind] = torch.zeros(
                    4 if kind == 0 else 3,
                    dtype=torch.int32 if kind == 0 else torch.int64,
                    device=buf.device)
            scratch = self.states[kind]
        rc = ck._bind(self.lib, "ldrsx_checksum_buffer")(
            kind, buf.data_ptr(), n, init, scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"{self.label}: CUDA error {rc}"
        return out


def cold_ms(fn, flush) -> float:
    """Device time per call with L2 flushed before each: REPS of (flush,
    event, call, event) enqueued behind a device sleep, the events'
    spans summed."""
    import torch

    from tail_probe import REPS
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(50_000_000)
    for start, end in evs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / REPS


def stamps(build: Build, fn) -> list[int]:
    """Block 0's clock64() stamps of the second of two calls of fn
    through a stages build (the copy clears them in this tree's source;
    an older source leaves them, and takes the same call twice)."""
    import numpy as np
    import torch

    entry = build.lib.ldrsx_checksum_stages
    entry.argtypes, entry.restype = [ctypes.c_void_p], ctypes.c_int
    host = np.zeros(64, np.int64)
    fn()                                             # the build's first
    torch.cuda.synchronize()
    assert entry(host.ctypes.data) == 0
    host[:] = 0
    fn()
    torch.cuda.synchronize()
    assert entry(host.ctypes.data) == 0
    return host[host != 0].tolist()


def stages(say, card, build: Build, rows, lengths) -> None:
    """Block 0's stamps of one crc32_blocks call through a stages build."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    t = stamps(build, lambda: build.rows(ck.crc32_blocks, rows, lengths))
    d = [b - a for a, b in zip(t, t[1:])]
    if build.new:
        names = ["tables"] + [f"step {k} {s}"
                              for k in range((len(d) - 1) // 3)
                              for s in ("hash", "fold", "finish")]
    else:
        names = ["tables", "spans", "fold"]
    say(f"{build.label}: block 0 of crc32_blocks on the corpus's rows, "
        f"{t[-1] - t[0]} cycles: "
        + ", ".join(f"{n} {c}" for n, c in zip(names, d)) + f" [{card}]")


ADLER_STAGES = ("loads", "group sums", "block sums", "atomics", "finish")


def adler_stages(say, card, build: Build, calls) -> None:
    """Block 0's stamps of each Adler call through a stages build of the
    tile design: a tile's start, its loads' arrival, the group sums, the
    block's sums, the atomics and the finish (a row of one tile takes no
    atomics), then the next tile's start."""
    for label, fn in calls:
        t = stamps(build, lambda: fn(build))
        per = len(ADLER_STAGES) + 1
        parts = []
        for k in range(0, len(t) - per + 1, per):
            tile = t[k:k + per]
            parts.append(f"tile {k // per}: " + ", ".join(
                f"{n} {b - a}" for n, a, b in zip(ADLER_STAGES, tile,
                                                  tile[1:])))
        say(f"{build.label}: block 0 of {label}, {t[-1] - t[0]} cycles: "
            + "; ".join(parts) + f" [{card}]")


def versus(say, card, dirs, ablate, turns, cases) -> None:
    """Device time of each call with the default build and each DIR's,
    in turns, L2 warm and flushed before each call (the CRC's buffer
    warm only); each Adler call's kernels by name; then the stage split
    of each. Builds from `ablate` are timed in the same turns without
    the equality check."""
    import torch

    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from tail_probe import device_ms

    own = os.path.join(_build.CSRC, "checksums.cu")
    sources = [own] + [os.path.join(d, "checksums.cu") for d in dirs + ablate]
    labels = ["default"] + list(dirs) + list(ablate)
    builds = [Build(label, variant(src, f"versus{i}"), is_new(src),
                    adler_is_new(src))
              for i, (label, src) in enumerate(zip(labels, sources))]
    unchecked = set(ablate)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    calls = adler_calls(cases) + (
        ("crc32_blocks", lambda b: b.rows(ck.crc32_blocks, cases["rows"],
                                          cases["n64"])),
        ("crc32 buffer", lambda b: b.buffer(0, cases["buf"], cases["n"], 0,
                                            cases["regs"])))
    want = [fn(builds[0]) for _, fn in calls]
    names = [name for name, _ in calls]
    names += [f"{name} cold" for name in names if name != "crc32 buffer"]
    times = {b.label: {name: [] for name in names} for b in builds}
    order = (builds + builds[1:][::-1] + builds[:1]) * turns
    for b in order:
        for (name, fn), w in zip(calls, want):
            assert b.label in unchecked or torch.equal(fn(b), w), \
                (b.label, name)
            times[b.label][name].append(device_ms(lambda: fn(b)))
            if name != "crc32 buffer":
                times[b.label][f"{name} cold"].append(
                    cold_ms(lambda: fn(b), flush))
    for label, by in times.items():
        say(f"{label}: " + "; ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            for name, ts in by.items())
            + " on the device, in turns; "
            + ("not checked" if label in unchecked else "equal")
            + f" [{card}]")
    from tail_probe import kernels_us
    for b in builds:
        for name, fn in calls[:3]:
            say(f"{b.label}: {name}, kernels (torch.profiler): " + ", ".join(
                f"{k[:40]} {us:.2f} us" for k, us in kernels_us(
                    lambda: fn(b))) + f" [{card}]")
    del flush
    for i, (label, src) in enumerate(zip(labels, sources)):
        b = Build(label, variant(src, f"stages{i}", stages=True),
                  is_new(src), adler_is_new(src))
        stages(say, card, b, cases["rows"], cases["n64"])
        if b.adler_new:
            adler_stages(say, card, b, adler_calls(cases))


def adler_calls(cases):
    """The three Adler calls through a build: (label, fn(build))."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    return (("adler32_blocks", lambda b: b.rows(
                ck.adler32_blocks, cases["rows"], cases["n64"])),
            ("adler32 buffer", lambda b: b.buffer(
                1, cases["buf"], cases["n"], 1, cases["regs"])),
            ("adler32_blocks 17 x 1 MiB", lambda b: b.rows(
                ck.adler32_blocks, cases["items"], cases["item_lens"])))


def record_versus(say, card, roots, turns, rows, n32) -> None:
    """The smoke's checksums record (crc32_blocks and adler32_blocks on
    the 259 rows, int32 lengths, 5 calls between CUDA events) through
    this tree's package and each root's, a process each, in turns; each
    root's kernels built under its own build/, the libraries of sources
    equal to this tree's copied there first."""
    import json
    import shutil
    import statistics

    import numpy as np

    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    npz = os.path.join(os.path.dirname(_build.BUILD_DIR), "record_rows.npz")
    np.savez(npz, rows=rows.cpu().numpy(), n32=n32.cpu().numpy(),
             crc=ck.crc32_blocks(rows, n32).cpu().numpy(),
             adler=ck.adler32_blocks(rows, n32).cpu().numpy())
    roots = [os.path.abspath(r) for r in roots]
    for root in roots:
        dest = os.path.join(root, "build", "kernels")
        os.makedirs(dest, exist_ok=True)
        for so in glob.glob(os.path.join(_build.BUILD_DIR, "*.so")):
            shutil.copy(so, dest)
    labels = [ROOT] + roots
    times = {label: {} for label in labels}
    for label in (labels + labels[1:][::-1] + labels[:1]) * turns:
        out = subprocess.run(
            [sys.executable, "-c", RECORD.format(root=label, npz=npz,
                                                 samples=SAMPLES)],
            capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        for name, ts in json.loads(out.stdout.splitlines()[-1]).items():
            times[label].setdefault(name, []).append(ts)
    what = {"": "ms a call over 5 calls by CUDA events, as the smoke "
                "times it",
            " host": "µs a call of the wrapper on the host clock, 5 calls "
                     "enqueued",
            " C entry": "µs a call of the bare C entry on the host clock",
            "yardstick": "µs a call of lengths.to(int64) on the host clock"}
    for label, by in times.items():
        tag = "tree" if label == ROOT else label
        for name, runs in by.items():
            kind = next((k for k in (" host", " C entry", "yardstick")
                         if name.endswith(k)), "")
            say(f"record {tag}: {name} on the 259 rows (int32 lengths), "
                f"{what[kind]}; per process in turns, median [least, most] "
                f"of {SAMPLES}: " + "; ".join(
                    f"{statistics.median(ts):.4f} [{min(ts):.4f}, "
                    f"{max(ts):.4f}]" for ts in runs) + f" [{card}]")
        pairs = [sorted(a + b for a, b in zip(*runs)) for runs in
                 zip(by["crc32_blocks"], by["adler32_blocks"])]
        say(f"record {tag}: the pair summed (ms), median [least, most] a "
            f"process: " + "; ".join(
                f"{statistics.median(p):.4f} [{p[0]:.4f}, {p[-1]:.4f}]"
                for p in pairs) + f" [{card}]")


def probe(say, dirs, ablate, turns, roots=()) -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from tail_probe import device_ms, kernels_us, wall_ms

    if not torch.cuda.is_available():
        print("checksum_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    nblk = -(-len(data) // cs.SLICE)
    arr = np.zeros(nblk * cs.SLICE, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    rows = torch.from_numpy(arr.reshape(nblk, cs.SLICE)).cuda()
    n32 = torch.tensor([min(cs.SLICE, len(data) - i * cs.SLICE)
                        for i in range(nblk)], dtype=torch.int32,
                       device="cuda")
    n64 = n32.long()
    full = torch.full_like(n64, cs.SLICE)
    nitem = -(-len(data) // cs.ITEM)
    items = np.zeros(nitem * cs.ITEM, np.uint8)
    items[:len(data)] = np.frombuffer(data, np.uint8)
    items = torch.from_numpy(items.reshape(nitem, cs.ITEM)).cuda()
    item_lens = torch.tensor([min(cs.ITEM, len(data) - i * cs.ITEM)
                              for i in range(nitem)], device="cuda")
    buf = ck._padded(data, ck.CRC_CHUNK, "cuda")
    nbytes = len(data) + 4 * nblk + 8 * nblk
    say(f"bound of a blocks call on the {nblk} rows: "
        f"{nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes at 3.35 "
        f"TB/s); on the {nitem} rows of 1 MiB "
        f"{(len(data) + 16 * nitem) / cs.HBM_BYTES_PER_MS:.6f} ms; of a "
        f"buffer call {(len(data) + 8) / cs.HBM_BYTES_PER_MS:.6f} ms")
    calls = (
        ("crc32_blocks, 259 rows, int32 lengths",
         lambda: ck.crc32_blocks(rows, n32)),
        ("crc32_blocks, 259 rows, int64 lengths",
         lambda: ck.crc32_blocks(rows, n64)),
        ("crc32_blocks, 259 rows, every length 65,536",
         lambda: ck.crc32_blocks(rows, full)),
        ("adler32_blocks, 259 rows, int32 lengths",
         lambda: ck.adler32_blocks(rows, n32)),
        ("adler32_blocks, 259 rows, int64 lengths",
         lambda: ck.adler32_blocks(rows, n64)),
        (f"adler32_blocks, {nitem} rows of 1 MiB, int64 lengths",
         lambda: ck.adler32_blocks(items, item_lens)),
        ("crc32_fixed, the corpus as one buffer",
         lambda: ck.crc32_fixed(buf, len(data), 0)),
        ("adler32_fixed, the corpus as one buffer",
         lambda: ck.adler32_fixed(buf, len(data), 1)),
    )
    for name, fn in calls:
        say(f"{name}: wall {wall_ms(fn):.4f} ms, device {device_ms(fn):.4f} "
            f"ms per call [{card}]")
        for kernel, us in kernels_us(fn):
            say(f"  {us:9.2f} us  {kernel[:90]}")
    out = subprocess.run([sys.executable, "-c", FIRST_CALLS.format(root=ROOT)],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        say(out.stderr[-2000:])
        return out.returncode
    for line in out.stdout.splitlines():
        say(f"{line} [{card}]")
    for log in glob.glob(_build.library_path("checksums") + ".log"):
        text = open(log).read()
        for entry in text.split("Compiling entry function")[1:]:
            head = entry.split("\n", 1)[0]
            kernel = "crc_kernel<" + ("buffer" if "ILb1E" in head
                                      else "rows") + ">" \
                if "crc_kernel" in head else "adler_kernel<" + (
                    "aligned" if "ILb1E" in head else "unaligned") + ">" \
                if "adler_kernel" in head else None
            if kernel:
                say(kernel + ": " + " ".join(
                    line.replace("ptxas info    :", "").strip()
                    for line in entry.splitlines()[2:4]))
    if roots:
        record_versus(say, card, roots, turns, rows, n32)
    cases = {"rows": rows, "n64": n64, "buf": buf, "n": len(data),
             "items": items, "item_lens": item_lens,
             "regs": torch.empty(nblk, dtype=torch.int64, device="cuda")}
    own = os.path.join(_build.CSRC, "checksums.cu")
    if dirs or ablate:
        versus(say, card, dirs, ablate, turns, cases)
    else:
        b = Build("default", variant(own, "stages0", True), True)
        stages(say, card, b, rows, n64)
        adler_stages(say, card, b, adler_calls(cases))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--versus", nargs="*", default=[],
                    help="also time the checksums.cu in these directories")
    ap.add_argument("--ablate", nargs="*", default=[],
                    help="also time the checksums.cu in these directories "
                    "(cut-down copies), without the equality check")
    ap.add_argument("--ablate-adler", action="store_true",
                    help="also time the ADLER_ABLATIONS copies of this "
                    "tree's source, without the equality check")
    ap.add_argument("--record-versus", nargs="*", default=[],
                    help="also time chip_smoke.py's checksums record "
                    "through the package of these checkouts, in turns")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of turns with --versus and "
                    "--record-versus")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        ablate = list(args.ablate)
        if args.ablate_adler:
            sys.path.insert(0, ROOT)
            from libdeflate_rsx_tpu_torch.ops import _build
            ablate += adler_ablations(os.path.join(_build.CSRC,
                                                   "checksums.cu"))
        return probe(say, args.versus, ablate, args.turns,
                     args.record_versus)


if __name__ == "__main__":
    sys.exit(main())
