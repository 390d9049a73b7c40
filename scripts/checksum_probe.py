#!/usr/bin/env python3
"""Where the device checksums' time goes on one CUDA card
(ops/checksums.py over csrc/checksums.cu).

Usage: python3 scripts/checksum_probe.py [--out FILE] [--versus DIR ...]
                                         [--ablate DIR ...] [--turns N]

Inputs: chip_smoke.py's corpus (16,936,000 bytes) as the sharded static
tier hands it over, 259 zero-padded rows of 64 KiB with int32 lengths
(and again with int64 lengths, which skip the wrapper's conversion, and
with every length 65,536, which leaves no short span), and as one
buffer. For crc32_blocks, adler32_blocks, crc32_fixed and
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
table build, and a step's hashing, fold to the row and finish. With
--versus, builds of the checksums.cu in each DIR (another version of
the source: `git archive HEAD libdeflate_rsx_tpu_torch/csrc | tar -x
-C build/parent` gives the parent's) are timed in turns with the
default build (default, versions, versions, default, --turns times) on
the blocks calls and the buffer calls, the CRC blocks call also with
L2 flushed before each call, each held equal to the default; and the
stage split is taken of each DIR's kernel too, where its source is PR
19's (stamps put into a copy: block 0 is row 0, its start, its tables,
its spans, its fold). --ablate DIR builds (copies of the source with a
stage cut out, whose results are wrong) are timed in the same turns,
unchecked, with their stage splits. Every line names the card. Needs
one CUDA card.
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


def is_new(source: str) -> bool:
    """Whether a checksums.cu has this tree's CRC design (crc_kernel)."""
    return "crc_kernel" in open(source).read()


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
    """One build of checksums.cu: its rows entry through the dispatchers,
    its buffer entry with the scratch its design takes (the CRC's zeroed
    state in this tree's design, else a row register a row)."""

    def __init__(self, label: str, lib, new: bool):
        self.label, self.lib, self.new = label, lib, new
        self.state = None

    def rows(self, fn, rows, lengths):
        from libdeflate_rsx_tpu_torch.ops import checksums as ck
        default = ck._kernel
        ck._kernel = lambda name: ck._bind(self.lib, name)
        try:
            return fn(rows, lengths)
        finally:
            ck._kernel = default

    def buffer(self, kind: int, buf, n: int, init: int, scratch):
        import torch

        from libdeflate_rsx_tpu_torch.ops import checksums as ck
        out = torch.empty((), dtype=torch.int64, device=buf.device)
        if self.new and kind == 0:
            if self.state is None:
                self.state = torch.zeros(4, dtype=torch.int32,
                                         device=buf.device)
            scratch = self.state
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


def stages(say, card, build: Build, rows, lengths) -> None:
    """Block 0's stamps of one crc32_blocks call through a stages build."""
    import numpy as np
    import torch

    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    fn = build.lib.ldrsx_checksum_stages
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    host = np.zeros(64, np.int64)
    build.rows(ck.crc32_blocks, rows, lengths)       # the build's first
    torch.cuda.synchronize()
    host[:] = 0
    build.rows(ck.crc32_blocks, rows, lengths)
    torch.cuda.synchronize()
    assert fn(host.ctypes.data) == 0
    t = host[host != 0].tolist()
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


def versus(say, card, dirs, ablate, turns, rows, lengths, buf, n) -> None:
    """Device time of each call with the default build and each DIR's,
    in turns; the CRC blocks call also with L2 flushed before each
    call; then the stage split of each. Builds from `ablate` are timed
    in the same turns without the equality check."""
    import torch

    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from tail_probe import device_ms

    own = os.path.join(_build.CSRC, "checksums.cu")
    builds = [Build("default", variant(own, "default"), True)]
    builds += [Build(d, variant(os.path.join(d, "checksums.cu"),
                                f"versus{i}"),
                     is_new(os.path.join(d, "checksums.cu")))
               for i, d in enumerate(dirs + ablate)]
    unchecked = set(ablate)
    regs = torch.empty(-(-n // 65536), dtype=torch.int64, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    calls = (
        ("crc32_blocks", lambda b: b.rows(ck.crc32_blocks, rows, lengths)),
        ("adler32_blocks", lambda b: b.rows(ck.adler32_blocks, rows,
                                            lengths)),
        ("crc32 buffer", lambda b: b.buffer(0, buf, n, 0, regs)),
        ("adler32 buffer", lambda b: b.buffer(1, buf, n, 1, regs)),
    )
    want = [fn(builds[0]) for _, fn in calls]
    times = {b.label: {name: [] for name, _ in calls + (("crc32_blocks "
                                                         "cold", None),)}
             for b in builds}
    order = (builds + builds[1:][::-1] + builds[:1]) * turns
    for b in order:
        for (name, fn), w in zip(calls, want):
            assert b.label in unchecked or torch.equal(fn(b), w), \
                (b.label, name)
            times[b.label][name].append(device_ms(lambda: fn(b)))
        times[b.label]["crc32_blocks cold"].append(
            cold_ms(lambda: calls[0][1](b), flush))
    for label, by in times.items():
        say(f"{label}: " + "; ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
            for name, ts in by.items())
            + " on the device, in turns; "
            + ("not checked" if label in unchecked else "equal")
            + f" [{card}]")
    for i, d in enumerate(["default"] + list(dirs) + list(ablate)):
        src = own if i == 0 else os.path.join(d, "checksums.cu")
        b = Build(d, variant(src, f"stages{i}", stages=True), is_new(src))
        stages(say, card, b, rows, lengths)


def probe(say, dirs, ablate, turns) -> int:
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
    buf = ck._padded(data, ck.CRC_CHUNK, "cuda")
    nbytes = len(data) + 4 * nblk + 8 * nblk
    say(f"bound of a blocks call: {nbytes / cs.HBM_BYTES_PER_MS:.6f} ms "
        f"({nbytes} bytes at 3.35 TB/s); of a buffer call "
        f"{(len(data) + 8) / cs.HBM_BYTES_PER_MS:.6f} ms")
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
            if "crc_kernel" in entry.split("\n", 1)[0]:
                say("crc_kernel<" + ("buffer" if "ILb1E" in entry
                                     else "rows") + ">: " + " ".join(
                    line.replace("ptxas info    :", "").strip()
                    for line in entry.splitlines()[2:4]))
    own = os.path.join(_build.CSRC, "checksums.cu")
    if dirs or ablate:
        versus(say, card, dirs, ablate, turns, rows, n64, buf, len(data))
    else:
        stages(say, card, Build("default", variant(own, "stages0", True),
                                True), rows, n64)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--versus", nargs="*", default=[],
                    help="also time the checksums.cu in these directories")
    ap.add_argument("--ablate", nargs="*", default=[],
                    help="also time the checksums.cu in these directories "
                    "(cut-down copies), without the equality check")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of turns with --versus")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say, args.versus, args.ablate, args.turns)


if __name__ == "__main__":
    sys.exit(main())
