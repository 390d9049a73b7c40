"""Device ops of the port: the CUDA kernels' wrappers with their plain
PyTorch versions, and the plain PyTorch encode, checksum and resolve
graphs.

Exports `inflate_device_static`, as the JAX package's ops/pallas does:
the decode of stored and static-Huffman streams (inflate_static.py);
and the device checksums `crc32_device` and `adler32_device`
(checksums.py).
"""

from .checksums import adler32_device, crc32_device
from .inflate_static import inflate_device_static

__all__ = ["adler32_device", "crc32_device", "inflate_device_static"]
