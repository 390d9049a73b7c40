"""Token selection of the device encoders on the card.

Counterpart of what follows the match finder in the JAX package: run
extension (`ops/encode_v2.py` `extend_runs`), for the L6 tier the
history mask and the one-position lazy demotion (`ops/encode_dynamic.py`
`analyze_block_l6`), greedy selection (`encode_v2.select_tokens`) and,
for the dynamic tiers, the per-block litlen and offset histograms.
`select` launches the CUDA kernel `csrc/select.cu` for CUDA tensors and
runs the plain version, `select_plain` (the port's copy of those
graphs), for CPU tensors. Both give the same outputs; the kernel's
source notes its design (a thread block per tile of a window over its
halos, every tile at once, the run start passed by a look-back over the
window's earlier tiles, every cell walked at once, in one launch).

The three callers take the same function with their flags:
`analyze_block_l6` (l6: cells of 256, outputs from HIST, lazy demotion,
histograms), `analyze_block` (cells of 64, histograms) and
`encode_rows_static` (cells of 64, no histograms).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .encode_dynamic import HIST, WTILE_L6, _histograms, select_tokens_l6
from .encode_v2 import WTILE, extend_runs, select_tokens

__all__ = ["select", "select_plain"]

#: kernel launches made by `select` (the plain version does not count)
LAUNCHES = 0


def _lib():
    lib = _build.load("select")
    if lib.ldrsx_select.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ldrsx_select.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i,
                                     i, i, p, p, p, p, p, p, p]
        lib.ldrsx_select.restype = ctypes.c_int
        lib.ldrsx_select_scratch.argtypes = [i, i, i, i]
        lib.ldrsx_select_scratch.restype = ctypes.c_longlong
    return lib


def select_plain(ml: torch.Tensor, dist: torch.Tensor,
                 valid_len: torch.Tensor, data: torch.Tensor | None = None,
                 l6: bool = False):
    """The plain version of `select`: extend_runs, then select_tokens_l6
    (l6) or select_tokens, sliced from HIST at l6, then the histograms
    of the bytes data[:, start:s] when data is given."""
    valid_len = valid_len.to(torch.int64)
    ml = extend_runs(ml, dist, valid_len)
    if l6:
        ml, sel, lit = select_tokens_l6(ml, dist, valid_len)
    else:
        ml, sel, lit = select_tokens(ml, dist, valid_len)
    start = HIST if l6 else 0
    out = tuple(x[:, start:] for x in (ml, dist, sel, lit))
    if data is None:
        return out
    byte = data[:, start:dist.shape[1]].to(torch.int64)
    return out + _histograms(byte, *out)


def select(ml: torch.Tensor, dist: torch.Tensor, valid_len: torch.Tensor,
           data: torch.Tensor | None = None, l6: bool = False):
    """Selected tokens of windows of s positions from the match finder's
    (ml, dist), int64 (B, s), and valid_len (B,).

    l6: the L6 tier's flags (ml zeroed below HIST, lazy demotion, cells
    of WTILE_L6, outputs from HIST); otherwise cells of WTILE and outputs
    from 0. Returns (ml int64, dist, sel bool, lit bool), each (B, s -
    start), dist a slice of its input; with data (B, >= s) uint8, whose
    byte p is position p's, also (ll_hist (B, 288), of_hist (B, 30))
    uint16 of the selected tokens and literals, saturated at 65,535.
    CUDA tensors launch the kernel, and raise on a shape it does not
    take; CPU tensors run `select_plain`."""
    global LAUNCHES
    if ml.device.type == "cpu":
        return select_plain(ml, dist, valid_len, data, l6)
    start, wtile = (HIST, WTILE_L6) if l6 else (0, WTILE)
    b, s = ml.shape if ml.dim() == 2 else (-1, -1)
    if ml.dim() != 2 or ml.dtype != torch.int64 or dist.shape != ml.shape \
            or dist.dtype != torch.int64 or valid_len.shape != (b,) \
            or s < start or s % wtile or (data is not None and (
                data.dim() != 2 or data.dtype != torch.uint8
                or data.shape[0] != b or data.shape[1] < s)):
        raise ValueError(
            f"select: ml {tuple(ml.shape)} {ml.dtype}, dist "
            f"{tuple(dist.shape)} {dist.dtype}, valid_len "
            f"{tuple(valid_len.shape)}, data "
            f"{None if data is None else (tuple(data.shape), data.dtype)};"
            f" want int64 (B, s) with s >= {start} and a multiple of "
            f"{wtile}, (B,), and uint8 (B, >= s) or None")
    dev = ml.device
    n = s - start
    # the kernel reads (ml, dist) with 16-byte loads
    mlc, distc = (x.contiguous() for x in (ml, dist))
    mlc, distc = (x if x.data_ptr() % 16 == 0 else
                  x.clone(memory_format=torch.contiguous_format)
                  for x in (mlc, distc))
    valid = valid_len.to(device=dev, dtype=torch.int32).contiguous()
    rows = None if data is None else data.contiguous()
    # the kernel writes every element of its outputs
    ml_out = torch.empty((b, n), dtype=torch.int64, device=dev)
    sel = torch.empty((b, n), dtype=torch.bool, device=dev)
    lit = torch.empty((b, n), dtype=torch.bool, device=dev)
    out = (ml_out, dist[:, start:], sel, lit)
    if data is not None:
        ll = torch.empty((b, 288), dtype=torch.uint16, device=dev)
        of = torch.empty((b, 30), dtype=torch.uint16, device=dev)
        out += (ll, of)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        lib = _lib()
        # the kernel's state (cleared by the C call before its launch)
        state = torch.empty(max(lib.ldrsx_select_scratch(
            b, s, start, int(data is not None)), 4), dtype=torch.uint8,
            device=dev)
        rc = lib.ldrsx_select(
            mlc.data_ptr(), distc.data_ptr(), valid.data_ptr(),
            None if rows is None else rows.data_ptr(),
            0 if rows is None else rows.shape[1], b, s, start, wtile, int(l6),
            ml_out.data_ptr(), sel.data_ptr(), lit.data_ptr(),
            None if data is None else ll.data_ptr(),
            None if data is None else of.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"select kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
