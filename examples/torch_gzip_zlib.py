"""Container formats: gzip and zlib framing, interop with stdlib, with
the PyTorch port (reference examples/gzip_zlib.rs; the JAX package's
examples/gzip_zlib.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import gzip
import zlib

import libdeflate_rsx_tpu_torch as ld

data = open(__file__, "rb").read()

c = ld.Compressor(level=9)
gz = c.compress_gzip(data)
zz = c.compress_zlib(data)
print(f"gzip: {len(gz)} bytes, zlib: {len(zz)} bytes")

# our containers decode with the standard tools…
assert gzip.decompress(gz) == data
assert zlib.decompress(zz) == data

# …and their containers decode with us
d = ld.Decompressor()
assert d.decompress_gzip(gzip.compress(data), len(data)) == data
assert d.decompress_zlib(zlib.compress(data), len(data)) == data
print("cross-interop OK")
