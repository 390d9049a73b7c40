"""libdeflate_rsx_tpu_torch — the PyTorch and CUDA port of
libdeflate_rsx_tpu's device paths, for NVIDIA Hopper (H100).

The host surface (one-shot and streaming codecs, checksums) is the JAX
package's JAX-free host layer, re-exported here; the batch classes are
the port's own and run their device tiers on a CUDA device:

- `BatchCompressor(level=6..9, use_device=True)`: the L6 ratio tier
  (models/greedy_dynamic.py), byte-identical to the JAX package's;
- `BatchDecompressor(use_device=True)`: the two-pass decoder, a CUDA
  pass-1 kernel (csrc/inflate_tokens.cu) and LZ resolution on the
  device or the host.

This package imports `torch` and never `jax`.
"""

from libdeflate_rsx_tpu import adler32, crc32
from libdeflate_rsx_tpu.api import (
    Compressor,
    Decompressor,
    deflate_compress_bound,
    gzip_compress_bound,
    zlib_compress_bound,
)
from libdeflate_rsx_tpu.stream import (
    DeflateDecoder,
    DeflateEncoder,
    GzipDecoder,
    GzipEncoder,
)

from .batch import BatchCompressor, BatchDecompressor

__version__ = "0.1.0"

__all__ = [
    "Compressor",
    "Decompressor",
    "BatchCompressor",
    "BatchDecompressor",
    "DeflateEncoder",
    "DeflateDecoder",
    "GzipEncoder",
    "GzipDecoder",
    "crc32",
    "adler32",
    "deflate_compress_bound",
    "zlib_compress_bound",
    "gzip_compress_bound",
    "__version__",
]
