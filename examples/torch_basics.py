"""One-shot compress/decompress round trip with the PyTorch port
(reference examples/basics.rs; the JAX package's examples/basics.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import libdeflate_rsx_tpu_torch as ld

data = b"hello hello hello compression world " * 100

comp = ld.Compressor(level=6)
compressed = comp.compress_deflate(data)
print(f"deflate: {len(data)} -> {len(compressed)} bytes")

decomp = ld.Decompressor()
restored = decomp.decompress_deflate(compressed, max_out=len(data))
assert restored == data
print("round trip OK")

# caller-provided buffers (the `_into` variants)
out = bytearray(ld.deflate_compress_bound(len(data)))
n = comp.compress_deflate_into(data, out)
back = bytearray(len(data))
m = decomp.decompress_deflate_into(bytes(out[:n]), back)
assert bytes(back[:m]) == data
print(f"_into variants OK ({n} compressed bytes)")
