#!/usr/bin/env python3
"""Where the device checksums' time goes on one CUDA card
(ops/checksums.py over csrc/checksums.cu).

Usage: python3 scripts/checksum_probe.py [--out FILE] [--threads N ...]
                                         [--versus DIR ...]

Inputs: chip_smoke.py's corpus (16,936,000 bytes) as the sharded static
tier hands it over, 259 zero-padded rows of 64 KiB with int32 lengths
(and again with int64 lengths, which skip the wrapper's conversion, and
with every length 65,536, which leaves no short span), and as one
buffer. For crc32_blocks, adler32_blocks, crc32_fixed and
adler32_fixed it prints
- the call's wall time, host clock, the card synchronised around it;
- the call's device time, CUDA events around calls enqueued behind a
  device sleep, so the host's enqueue time is hidden;
- each kernel's device time per call by name (torch.profiler);
then the walls of the first and second crc32_device and adler32_device
call of the corpus in a fresh process (the kernels already built), the
copy to the card included. With --threads, builds of the kernel at
other thread counts a row (its ROW_THREADS constant replaced in a copy
under build/kernels/), and with --versus
builds of the checksums.cu in each DIR (another version of the source:
`git archive HEAD libdeflate_rsx_tpu_torch/csrc | tar -x -C build/parent`
gives the parent's), are timed in turns with the default build on the
blocks calls, each held equal to it. Every line names the card. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
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


def variant(source: str, tag: str, threads: int | None = None):
    """A build of `source` (at `threads` threads a row: its ROW_THREADS
    constant replaced in a copy), loaded."""
    import ctypes
    import re

    from libdeflate_rsx_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    if threads is not None:
        text = re.sub(r"constexpr int ROW_THREADS = \d+;",
                      f"constexpr int ROW_THREADS = {threads};",
                      open(source).read())
        source = os.path.join(_build.BUILD_DIR, f"checksums-{tag}.cu")
        with open(source, "w") as f:
            f.write(text)
    so = os.path.join(_build.BUILD_DIR, f"checksums-{tag}.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, source],
                   check=True, capture_output=True)
    return ctypes.CDLL(so)


def versus(say, card, threads, dirs, rows, lengths) -> None:
    """Device time of each blocks call with the default build and each
    variant, in turns (default, variants, variants, default)."""
    import torch

    from libdeflate_rsx_tpu_torch.ops import _build
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from tail_probe import device_ms

    own = os.path.join(_build.CSRC, "checksums.cu")
    libs = [(f"{t} threads", variant(own, f"threads{t}", t))
            for t in threads]
    libs += [(d, variant(os.path.join(d, "checksums.cu"), f"versus{i}"))
             for i, d in enumerate(dirs)]
    default = ck._kernel
    builds = [("default", default)] + [
        (label, (lambda lib: lambda name: ck._bind(lib, name))(lib))
        for label, lib in libs]
    fns = (("crc32_blocks", ck.crc32_blocks),
           ("adler32_blocks", ck.adler32_blocks))
    want = [fn(rows, lengths) for _, fn in fns]
    times = {label: [] for label, _ in builds}
    try:
        for label, kernel in builds + builds[1:][::-1] + builds[:1]:
            ck._kernel = kernel
            for (name, fn), w in zip(fns, want):
                assert torch.equal(fn(rows, lengths), w), (label, name)
            times[label].append([device_ms(lambda: fn(rows, lengths))
                                 for _, fn in fns])
    finally:
        ck._kernel = default
    for label, runs in times.items():
        say(f"{label}: crc32_blocks " + " / ".join(f"{r[0]:.4f}" for r in runs)
            + " ms, adler32_blocks " + " / ".join(f"{r[1]:.4f}" for r in runs)
            + f" ms on the device, in turns; equal [{card}]")


def probe(say, threads, dirs) -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
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
    if threads or dirs:
        versus(say, card, threads, dirs, rows, n64)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    ap.add_argument("--threads", type=int, nargs="*", default=[],
                    help="also time builds at these thread counts a row")
    ap.add_argument("--versus", nargs="*", default=[],
                    help="also time the checksums.cu in these directories")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say, args.threads, args.versus)


if __name__ == "__main__":
    sys.exit(main())
