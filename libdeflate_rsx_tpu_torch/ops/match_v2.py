"""The L1-5 match finder on the card.

Counterpart of the JAX package's `ops/encode_v2.py` `find_matches_v2`.
`ops/encode_v2.find_matches_v2` calls `find_matches_v2_cuda` here for
CUDA tensors, which launches the CUDA kernel `csrc/match_v2.cu`, and
runs the plain version, `encode_v2.find_matches_v2_plain`, for CPU
tensors. Both give the same `(ml, dist)`, int64 `(B, s)`, for every
position of every block (the plain version's docstring states the
function; the kernel's source notes its design: a thread block cluster
per window of at most WINDOW_MAX positions, the window's positions
sorted by word in distributed shared memory, then one sweep, in one
launch).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["check_v2_block", "find_matches_v2_cuda", "launch_shape"]

#: kernel launches made by `find_matches_v2_cuda` (the plain version
#: does not count)
LAUNCHES = 0
#: largest block size the kernel takes
MAX_BLOCK = 1 << 30
#: positions one cluster sorts: a block up to this size is one window
WINDOW_MAX = 65536
#: outputs of each window of a longer block, which also takes the
#: REACH positions before them
SEGMENT = 32768
REACH = 32768
#: bytes a row must hold past the block: the words read 7 bytes past
#: it, and the kernel's aligned copy up to 16 more
ROW_PAD = 24


def _lib():
    lib = _build.load("match_v2")
    if lib.ldrsx_match_v2.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ldrsx_match_v2_shape.argtypes = [i, ip, ip, ip]
        lib.ldrsx_match_v2_shape.restype = ctypes.c_int
        lib.ldrsx_match_v2.argtypes = [p, i, i, i, p, p, p, p]
        lib.ldrsx_match_v2.restype = ctypes.c_int
    return lib


def check_v2_block(s: int) -> None:
    """Raise ValueError for a block size the match finder does not take
    (below 1 or past MAX_BLOCK)."""
    if not 1 <= s <= MAX_BLOCK:
        raise ValueError(f"find_matches_v2: block size {s} is not in "
                         f"[1, {MAX_BLOCK}]")


def windows(s: int) -> list[tuple[int, int, int]]:
    """The kernel's windows of a block of s positions: (first position,
    first output, end), the window sorting positions [first, end) and
    giving the outputs [first output, end)."""
    if s <= WINDOW_MAX:
        return [(0, 0, s)]
    return [(max(0, o - REACH), o, min(s, o + SEGMENT))
            for o in range(0, s, SEGMENT)]


def launch_shape(s: int, device=None) -> tuple[int, int, int]:
    """(cluster size, dynamic shared memory of a block in bytes, clusters
    resident at once) of the kernel at block size s on the card; raises
    if the kernel does not take such blocks."""
    cs, smem, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _lib().ldrsx_match_v2_shape(s, ctypes.byref(cs),
                                         ctypes.byref(smem),
                                         ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"match_v2 kernel: no launch shape for blocks "
                           f"of {s} bytes (CUDA error {rc})")
    return cs.value, smem.value, clusters.value


def find_matches_v2_cuda(data_padded: torch.Tensor, valid_len: torch.Tensor,
                         s: int):
    """(ml, dist) int64 (B, s) of blocks on the card, by one launch of the
    kernel: data_padded (B, >= s + ROW_PAD) uint8 CUDA, valid_len (B,).
    Raises for CPU tensors and for shapes the kernel does not take."""
    global LAUNCHES
    check_v2_block(s)
    if data_padded.device.type != "cuda":
        raise ValueError("find_matches_v2_cuda: the kernel takes CUDA "
                         f"tensors, not {data_padded.device}")
    b = data_padded.shape[0]
    if data_padded.dim() != 2 or data_padded.dtype != torch.uint8 \
            or data_padded.shape[1] < s + ROW_PAD \
            or valid_len.shape != (b,):
        raise ValueError(
            f"find_matches_v2: data {tuple(data_padded.shape)} "
            f"{data_padded.dtype}, valid_len {tuple(valid_len.shape)}; want "
            f"uint8 (B, >= {s + ROW_PAD}), (B,)")
    dev = data_padded.device
    data = data_padded.contiguous()
    valid = valid_len.to(device=dev, dtype=torch.int32).contiguous()
    # the kernel writes every element of its outputs
    ml = torch.empty((b, s), dtype=torch.int64, device=dev)
    dist = torch.empty((b, s), dtype=torch.int64, device=dev)
    if b == 0:
        return ml, dist
    lib = _lib()
    # the C entry sizes the grid: as many clusters as the card holds at
    # once, at most one per window
    with torch.cuda.device(dev):
        rc = lib.ldrsx_match_v2(
            data.data_ptr(), b, data.shape[1], s, valid.data_ptr(),
            ml.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"match_v2 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return ml, dist
