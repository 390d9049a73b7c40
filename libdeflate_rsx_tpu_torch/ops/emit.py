"""The emit step of the device encoders on the card.

Counterpart of the JAX package's `ops/encode_dynamic.py` `emit_pack`
(levels 4-9) and of the static coding in `ops/encode_v2.py`
`encode_rows_static` (levels 1-3), each ending in `pack_rows`. `emit`
launches the CUDA kernel `csrc/emit.cu` for CUDA tensors and runs the
plain version, `emit_plain`, for CPU tensors: `encode_dynamic.
emit_pack_plain` with tables, `encode_v2.emit_static_plain` without.
Both give the same four outputs, every padding byte of the rows
included; the kernel's source notes its design (a thread block per tile
of 64 rows, 8 lanes a thread, the tile's base by a decoupled look-back,
in one launch).

The two callers: `encode_dynamic.emit_pack` (the dynamic mode:
per-block tables, the header's bits first, rows of ROW_OUT_DYN bytes)
and `encode_v2.encode_rows_static` (the static mode: the static codes,
the 3-bit header first, rows of ROW_OUT bytes).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .encode_dynamic import ROW_OUT_DYN, emit_pack_plain
from .encode_v2 import ROW, ROW_OUT, emit_static_plain

__all__ = ["emit", "emit_plain"]

#: kernel launches made by `emit` (the plain version does not count)
LAUNCHES = 0


def _lib():
    lib = _build.load("emit")
    if lib.ldrsx_emit.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ldrsx_emit.argtypes = [p, ll, p, ll, p, ll, p, ll, p, ll, p, p,
                                   p, i, i, p, p, p, p, p, p]
        lib.ldrsx_emit.restype = ctypes.c_int
        lib.ldrsx_emit_scratch.argtypes = [i, i]
        lib.ldrsx_emit_scratch.restype = ctypes.c_longlong
    return lib


def emit_plain(data: torch.Tensor, ml: torch.Tensor, dist: torch.Tensor,
               sel: torch.Tensor, lit: torch.Tensor, block_size: int,
               ll_tab: torch.Tensor | None = None,
               of_tab: torch.Tensor | None = None,
               start_bits: torch.Tensor | None = None):
    """The plain version of `emit`: emit_pack_plain with tables, else
    emit_static_plain."""
    if ll_tab is None:
        return emit_static_plain(data, ml, dist, sel, lit, block_size)
    return emit_pack_plain(data, ml, dist, sel, lit, ll_tab, of_tab,
                           start_bits, block_size)


def _lanes(x: torch.Tensor, align: int = 1) -> torch.Tensor:
    """x itself when its lanes are contiguous and its rows start on
    `align` bytes (the kernel takes the row stride, so a column slice
    needs no copy), else a contiguous copy."""
    if x.stride(1) == 1 and x.data_ptr() % align == 0 \
            and x.stride(0) * x.element_size() % align == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def emit(data: torch.Tensor, ml: torch.Tensor, dist: torch.Tensor,
         sel: torch.Tensor, lit: torch.Tensor, block_size: int,
         ll_tab: torch.Tensor | None = None,
         of_tab: torch.Tensor | None = None,
         start_bits: torch.Tensor | None = None):
    """Every lane's token coded and bit-packed into row buffers: (rows
    (B, R, row_out + 1) uint8, byte_off (B, R), row_bit0 (B, R), end_bits
    (B,)) int64, R = block_size / 32, pack_rows' layout.

    data uint8 (B, >= s) holds the bytes (byte p is lane p's), ml and
    dist int64 and sel and lit bool (B, s), s = block_size. With ll_tab
    (B, 288) and of_tab (B, 30) (`code | len << 16`, len <= 15) and
    start_bits (B,), the dynamic mode (row_out 64); without them, the
    static codes after a 3-bit header (row_out 48). CUDA tensors launch
    the kernel, and raise on a shape it does not take or a failed
    launch; CPU tensors run `emit_plain`."""
    global LAUNCHES
    if ml.device.type == "cpu":
        return emit_plain(data, ml, dist, sel, lit, block_size, ll_tab,
                          of_tab, start_bits)
    dyn = ll_tab is not None
    s = block_size
    b = ml.shape[0] if ml.dim() == 2 else -1
    lanes = (ml, dist, sel, lit)
    if ml.dim() != 2 or s <= 0 or s % ROW \
            or any(x.shape != (b, s) for x in lanes) \
            or ml.dtype != torch.int64 or dist.dtype != torch.int64 \
            or sel.dtype != torch.bool or lit.dtype != torch.bool \
            or data.dim() != 2 or data.dtype != torch.uint8 \
            or data.shape[0] != b or data.shape[1] < s \
            or (dyn and (of_tab is None or start_bits is None
                         or ll_tab.shape != (b, 288)
                         or of_tab.shape != (b, 30)
                         or start_bits.shape != (b,))):
        raise ValueError(
            f"emit: data {tuple(data.shape)} {data.dtype}, ml "
            f"{tuple(ml.shape)} {ml.dtype}, dist {tuple(dist.shape)} "
            f"{dist.dtype}, sel {tuple(sel.shape)} {sel.dtype}, lit "
            f"{tuple(lit.shape)} {lit.dtype}, block_size {s}; want uint8 "
            f"(B, >= s), int64 (B, s) twice, bool (B, s) twice, s a "
            f"positive multiple of {ROW}, and with tables (B, 288), "
            f"(B, 30) and start_bits (B,)")
    dev = ml.device
    r = s // ROW
    row_out = ROW_OUT_DYN if dyn else ROW_OUT
    # the kernel writes every element of its outputs
    rows = torch.empty((b, r, row_out + 1), dtype=torch.uint8, device=dev)
    byte_off = torch.empty((b, r), dtype=torch.int64, device=dev)
    row_bit0 = torch.empty((b, r), dtype=torch.int64, device=dev)
    end_bits = torch.empty(b, dtype=torch.int64, device=dev)
    out = (rows, byte_off, row_bit0, end_bits)
    if b == 0:
        return out
    # the kernel loads the flags 8 lanes and (ml, dist) 2 lanes at a time
    data, ml, dist, sel, lit = (_lanes(x, a) for x, a in (
        (data, 1), (ml, 16), (dist, 16), (sel, 8), (lit, 8)))
    if dyn:
        ll_tab, of_tab = (t.to(device=dev, dtype=torch.int32).contiguous()
                          for t in (ll_tab, of_tab))
        start = start_bits.to(device=dev, dtype=torch.int64).contiguous()
    else:
        start = torch.full((b,), 3, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        lib = _lib()
        # the kernel's state (cleared by the C call before its launch)
        state = torch.empty(lib.ldrsx_emit_scratch(b, r), dtype=torch.uint8,
                            device=dev)
        rc = lib.ldrsx_emit(
            data.data_ptr(), data.stride(0), ml.data_ptr(), ml.stride(0),
            dist.data_ptr(), dist.stride(0), sel.data_ptr(), sel.stride(0),
            lit.data_ptr(), lit.stride(0),
            ll_tab.data_ptr() if dyn else None,
            of_tab.data_ptr() if dyn else None, start.data_ptr(), b, r,
            rows.data_ptr(), byte_off.data_ptr(), row_bit0.data_ptr(),
            end_bits.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"emit kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
