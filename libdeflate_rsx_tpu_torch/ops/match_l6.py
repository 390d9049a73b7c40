"""The L6 match finder on the card.

Counterpart of the JAX package's `ops/encode_dynamic.py`
`find_matches_l6`. `find_matches_l6` launches the CUDA kernel
`csrc/match_l6.cu` for CUDA tensors and runs the plain version,
`encode_dynamic.find_matches_l6_plain`, for CPU tensors. Both give the
same `(ml, dist)`, int64 `(B, s)`, for every position of every window
(the plain version's docstring states the function; the kernel's source
notes its design: a thread block cluster per window with the window's
sorts in distributed shared memory, the ladder's levels refining only
the groups of two or more, and the covering decay by a cluster scan, in
one launch).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .encode_dynamic import (
    L6_LEVELS,
    L6_TIER_K,
    check_l6_window,
    find_matches_l6_plain,
)

__all__ = ["find_matches_l6", "launch_shape"]

#: kernel launches made by `find_matches_l6` (the plain version does not
#: count)
LAUNCHES = 0


def _lib():
    lib = _build.load("match_l6")
    if lib.ldrsx_match_l6.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ldrsx_match_l6_shape.argtypes = [i, ip, ip, ip]
        lib.ldrsx_match_l6_shape.restype = ctypes.c_int
        lib.ldrsx_match_l6.argtypes = [p, i, i, i, p, p, p, p, p]
        lib.ldrsx_match_l6.restype = ctypes.c_int
    return lib


def launch_shape(s: int, device=None) -> tuple[int, int, int]:
    """(cluster size, dynamic shared memory of a block in bytes, clusters
    resident at once) of the kernel at window s on the card; raises if
    the kernel does not take such windows."""
    cs, smem, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _lib().ldrsx_match_l6_shape(s, ctypes.byref(cs),
                                         ctypes.byref(smem),
                                         ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"match_l6 kernel: no launch shape for windows "
                           f"of {s} bytes (CUDA error {rc})")
    return cs.value, smem.value, clusters.value


def find_matches_l6(data_padded: torch.Tensor, valid_len: torch.Tensor,
                    hist_start: torch.Tensor, s: int, levels=L6_LEVELS,
                    tier_k: int = L6_TIER_K, k: int = 4):
    """(ml, dist) int64 (B, s) per position over [history | payload]
    windows: data_padded (B, >= s + 71) uint8, valid_len and hist_start
    (B,). CUDA tensors launch the kernel, which computes the default
    ladder (`levels`, `tier_k` and `k` as given here) and raises on any
    other; CPU tensors run `find_matches_l6_plain`."""
    global LAUNCHES
    check_l6_window(s, levels)
    if data_padded.device.type == "cpu":
        return find_matches_l6_plain(data_padded, valid_len, hist_start, s,
                                     levels, tier_k, k)
    if (tuple(levels), tier_k, k) != (L6_LEVELS, L6_TIER_K, 4):
        raise ValueError("find_matches_l6: the kernel computes levels "
                         f"{L6_LEVELS}, tier_k {L6_TIER_K}, k 4 only")
    b = data_padded.shape[0]
    if data_padded.dim() != 2 or data_padded.dtype != torch.uint8 \
            or data_padded.shape[1] < s + 71 \
            or valid_len.shape != (b,) or hist_start.shape != (b,):
        raise ValueError(
            f"find_matches_l6: data {tuple(data_padded.shape)} "
            f"{data_padded.dtype}, valid_len {tuple(valid_len.shape)}, "
            f"hist_start {tuple(hist_start.shape)}; want uint8 (B, >= "
            f"{s + 71}), (B,), (B,)")
    dev = data_padded.device
    data = data_padded.contiguous()
    valid = valid_len.to(device=dev, dtype=torch.int32).contiguous()
    hist = hist_start.to(device=dev, dtype=torch.int32).contiguous()
    # the kernel writes every element of its outputs
    ml = torch.empty((b, s), dtype=torch.int64, device=dev)
    dist = torch.empty((b, s), dtype=torch.int64, device=dev)
    if b == 0:
        return ml, dist
    lib = _lib()
    # the C entry sizes the grid: as many clusters as the card holds at
    # once, at most one per window
    with torch.cuda.device(dev):
        rc = lib.ldrsx_match_l6(
            data.data_ptr(), b, data.shape[1], s, valid.data_ptr(),
            hist.data_ptr(), ml.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"match_l6 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return ml, dist
