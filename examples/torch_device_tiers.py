"""The PyTorch port's device encoder tiers and its batch decoder.

Three compression tiers on the CUDA card (pick by batch level):
  level 0    -> stored blocks        (models/stored.py)
  levels 1-3 -> static Huffman       (models/greedy_static.py)
  levels 4-9 -> dynamic Huffman      (models/greedy_dynamic.py; 6-9 the
                                      L6 ratio tier)
and the device batch decoder: fewer than 8 streams take the small-batch
kernel (ops/inflate_v2.py, csrc/inflate_v2.cu) through
BatchDecompressor(use_device=True). The JAX package's
examples/device_tiers.py runs the same calls on a TPU.

  python examples/torch_device_tiers.py [--device cuda|cpu]

--device cpu runs every device step's plain PyTorch version on the CPU.
Without a card the default run fails at its first CUDA call.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import argparse
import zlib

from libdeflate_rsx_tpu_torch.batch import BatchCompressor, BatchDecompressor
from libdeflate_rsx_tpu_torch.models.greedy_dynamic import (
    deflate_device_dynamic)
from libdeflate_rsx_tpu_torch.models.greedy_static import (
    deflate_device_static)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
device = parser.parse_args().device

text = (b"the dynamic tier builds one Huffman code per 64 KiB block, "
        b"so entropy-skewed data like this sentence compresses harder. "
        ) * 3000

static = deflate_device_static(text, device=device)
dynamic = deflate_device_dynamic(text, device=device)
print(f"input {len(text)} B -> static tier {len(static)} B "
      f"({len(text) / len(static):.2f}x), dynamic tier {len(dynamic)} B "
      f"({len(text) / len(dynamic):.2f}x)")
assert zlib.decompress(static, -15) == text
assert zlib.decompress(dynamic, -15) == text

# the batch API picks the tier from the level
bc = BatchCompressor(level=6, format="gzip", use_device=True, device=device)
frames = bc.compress_batch([text, text[::-1]])
print(f"batch gzip: {[len(f) for f in frames]} bytes")

# device batch decode (raw DEFLATE payloads <= 64 KiB per stream)
chunks = [text[i:i + 65536 - 1024] for i in range(0, len(text), 65536)][:4]
comps = [zlib.compress(c, 6)[2:-4] for c in chunks]
bd = BatchDecompressor(use_device=True, device=device)
outs = bd.decompress_batch(comps, [len(c) for c in chunks])
assert outs == chunks
print(f"device batch decode: {len(outs)} streams, "
      f"{sum(len(o) for o in outs)} bytes, byte-exact")
