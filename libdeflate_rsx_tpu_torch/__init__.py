"""libdeflate_rsx_tpu_torch — the PyTorch and CUDA port of
libdeflate_rsx_tpu, for NVIDIA Hopper (H100).

The port keeps its own copy of the JAX package's host layer (one-shot
and streaming codecs, containers, checksums, the pure-Python engine of
models/portable/) and imports nothing of the JAX package. The batch
classes run their device tiers on a CUDA device:

- `BatchCompressor(level=0..9, use_device=True)`: the stored tier at
  level 0 (models/stored.py), the static-Huffman tier at levels 1-3
  (models/greedy_static.py), the dynamic tier at levels 4-5 and the L6
  ratio tier at levels 6-9 (models/greedy_dynamic.py), each
  byte-identical to the JAX package's;
- `BatchDecompressor(use_device=True)`: a batch of fewer than 8 items
  goes to the small-batch decoder (ops/inflate_v2.py, CUDA kernel
  csrc/inflate_v2.cu); 8 or more to the two-pass decoder, a CUDA pass-1
  kernel (csrc/inflate_tokens.cu) and LZ resolution on the device or
  the host.

`ops.inflate_device_static` decodes stored and static-Huffman streams
(csrc/inflate_static.cu); `ops.crc32_device` and `ops.adler32_device`
compute the checksums on the device (ops/checksums.py). `parallel`
shards compress and decode over a torch.distributed process group, one
rank per card. This package imports `torch` and never `jax`.
"""

from .api import (
    Compressor,
    Decompressor,
    deflate_compress_bound,
    gzip_compress_bound,
    zlib_compress_bound,
)
from . import parallel
from .batch import BatchCompressor, BatchDecompressor
from .engine import Deflater
from .engine import adler32 as adler32_host
from .engine import crc32 as crc32_host
from .stream import DeflateDecoder, DeflateEncoder, GzipDecoder, GzipEncoder
from .utils import errors

__version__ = "0.1.0"


def crc32(data, crc: int = 0) -> int:
    """CRC-32 (gzip polynomial) of `data`, continuing from `crc`."""
    return crc32_host(bytes(data), crc)


def adler32(data, adler: int = 1) -> int:
    """Adler-32 (zlib) of `data`, continuing from `adler`."""
    return adler32_host(bytes(data), adler)


__all__ = [
    "Compressor",
    "Decompressor",
    "BatchCompressor",
    "BatchDecompressor",
    "Deflater",
    "DeflateEncoder",
    "DeflateDecoder",
    "GzipEncoder",
    "GzipDecoder",
    "crc32",
    "adler32",
    "deflate_compress_bound",
    "zlib_compress_bound",
    "gzip_compress_bound",
    "errors",
    "__version__",
]
