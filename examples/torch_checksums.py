"""CRC-32 / Adler-32, incremental (running) use, and the associative
combine operators for sharded computation, with the PyTorch port
(reference examples/checksums.rs; the JAX package's
examples/checksums.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import zlib

import libdeflate_rsx_tpu_torch as ld
from libdeflate_rsx_tpu_torch.ops.checksum_math import (adler32_combine,
                                                        crc32_combine)

a = b"first part of the message, "
b = b"second part of the message"

# one-shot
crc = ld.crc32(a + b)
adl = ld.adler32(a + b)
assert crc == zlib.crc32(a + b)
assert adl == zlib.adler32(a + b)
print(f"crc32=0x{crc:08x} adler32=0x{adl:08x}")

# running (incremental) checksums
crc_run = ld.crc32(b, ld.crc32(a))
adl_run = ld.adler32(b, ld.adler32(a))
assert crc_run == crc and adl_run == adl
print("running checksums OK")

# associative combine: per-shard checksums reduce without re-reading data
crc_comb = crc32_combine(ld.crc32(a), ld.crc32(b), len(b))
adl_comb = adler32_combine(ld.adler32(a), ld.adler32(b), len(b))
assert crc_comb == crc and adl_comb == adl
print("sharded combine OK")
