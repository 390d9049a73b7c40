"""The L1-5 match finder on the card.

Counterpart of the JAX package's `ops/encode_v2.py` `find_matches_v2`.
`ops/encode_v2.find_matches_v2` calls `find_matches_v2_cuda` here for
CUDA tensors, which launches the CUDA kernel `csrc/match_v2.cu`, and
runs the plain version, `encode_v2.find_matches_v2_plain`, for CPU
tensors. Both give the same `(ml, dist)`, int64 `(B, s)`, for every
position of every block (the plain version's docstring states the
function; the kernel's source notes its design: a thread block cluster
per window of at most WINDOW_MAX positions, the window's positions
sorted by a 16-bit hash of their word in distributed shared memory, each
position's nearest earlier copy found by a walk through its bucket, in
one launch; a window in which a walk would pass more than WALK_CAP runs
of other words is sorted by the whole word instead, in the same launch,
and counted: `escapes`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["check_v2_block", "escapes", "find_matches_v2_cuda",
           "launch_shape", "reset_escapes"]

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
#: the kernel's hash of a word w: (w * HASH_MUL mod 2^32) >> 16
HASH_MUL = 0x9E3779B1
#: runs of other words a walk through a bucket may pass; a window where
#: one would pass more takes the sort by the whole word
WALK_CAP = 64


def _lib():
    lib = _build.load("match_v2")
    if lib.ldrsx_match_v2.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ldrsx_match_v2_shape.argtypes = [i, i, ip, ip, ip, ip]
        lib.ldrsx_match_v2_shape.restype = ctypes.c_int
        lib.ldrsx_match_v2.argtypes = [p, i, i, i, p, p, p, p]
        lib.ldrsx_match_v2.restype = ctypes.c_int
        lib.ldrsx_match_v2_escapes.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.ldrsx_match_v2_escapes.restype = ctypes.c_int
        lib.ldrsx_match_v2_reset_escapes.argtypes = []
        lib.ldrsx_match_v2_reset_escapes.restype = ctypes.c_int
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


def launch_shape(s: int, rows: int = 1,
                 device=None) -> tuple[int, int, int, int]:
    """(cluster size, dynamic shared memory of a block in bytes, clusters
    resident at once, rounds over the windows) of the kernel's launch on
    `rows` blocks of size s on the card; raises if the kernel does not
    take such blocks."""
    out = [ctypes.c_int() for _ in range(4)]
    with torch.cuda.device(device):
        rc = _lib().ldrsx_match_v2_shape(s, rows,
                                         *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"match_v2 kernel: no launch shape for blocks "
                           f"of {s} bytes (CUDA error {rc})")
    return tuple(x.value for x in out)


def escapes(device=None) -> int:
    """Windows of the kernel's launches on the card since the last
    `reset_escapes` that took the sort by the whole word (a walk would
    have passed WALK_CAP runs of other words); waits for the card."""
    out = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        rc = _lib().ldrsx_match_v2_escapes(ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"match_v2 escape count: CUDA error {rc}")
    return out.value


def reset_escapes(device=None) -> None:
    """Set the card's count of escaped windows (`escapes`) to 0."""
    with torch.cuda.device(device):
        rc = _lib().ldrsx_match_v2_reset_escapes()
    if rc != 0:
        raise RuntimeError(f"match_v2 escape count: CUDA error {rc}")


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
