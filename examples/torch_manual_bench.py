"""Manual wall-clock throughput check of the PyTorch port's host codec
(reference examples/manual_bench.rs; the JAX package's
examples/manual_bench.py). The port's own bench, which times the
device paths on the card, is still to come (ROADMAP item 13).

  python examples/torch_manual_bench.py [--size BYTES]   (default 4 MiB)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import argparse
import time
import zlib

import numpy as np

import libdeflate_rsx_tpu_torch as ld


def corpus(size: int) -> bytes:
    rng = np.random.default_rng(42)
    base = rng.integers(0, 256, 100, dtype=np.uint8)
    return np.tile(base, size // 100 + 1)[:size].tobytes()


parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--size", type=int, default=4 << 20,
                    help="input bytes (default 4 MiB)")
data = corpus(parser.parse_args().size)
for level in (1, 6, 9):
    c = ld.Compressor(level)
    t0 = time.perf_counter()
    comp = c.compress_deflate(data)
    dt = time.perf_counter() - t0
    print(f"level {level}: {len(data) / dt / 1e6:8.1f} MB/s "
          f"ratio {len(data) / len(comp):6.1f}x")

d = ld.Decompressor()
comp = zlib.compress(data, 6)[2:-4]
t0 = time.perf_counter()
out = d.decompress_deflate(comp, len(data))
dt = time.perf_counter() - t0
assert out == data
print(f"decompress: {len(data) / dt / 1e6:8.1f} MB/s")
