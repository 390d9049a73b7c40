"""Device ops of the port: the CUDA kernels' wrappers with their plain
PyTorch versions, and the plain PyTorch encode and resolve graphs.

Exports `inflate_device_static`, as the JAX package's ops/pallas does:
the decode of stored and static-Huffman streams (inflate_static.py).
"""

from .inflate_static import inflate_device_static

__all__ = ["inflate_device_static"]
