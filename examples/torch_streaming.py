"""Streaming encode/decode over file-like objects with the PyTorch port
(reference examples/streaming.rs; the JAX package's
examples/streaming.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import io

import libdeflate_rsx_tpu_torch as ld

data = b"streaming " * 50000

sink = io.BytesIO()
with ld.DeflateEncoder(sink, level=6) as enc:
    for i in range(0, len(data), 4096):
        enc.write(data[i:i + 4096])
compressed = sink.getvalue()
print(f"stream-encoded {len(data)} -> {len(compressed)} bytes")

dec = ld.DeflateDecoder(io.BytesIO(compressed))
out = bytearray()
while True:
    piece = dec.read(8192)
    if not piece:
        break
    out += piece
assert bytes(out) == data
print("stream round trip OK")
