"""The emit step of the device encoders on the card.

Counterpart of the JAX package's `ops/encode_dynamic.py` `emit_pack`
(levels 4-9) and of the static coding in `ops/encode_v2.py`
`encode_rows_static` (levels 1-3), each ending in `pack_rows`. `emit`
launches the CUDA kernel `csrc/emit.cu` for CUDA tensors and runs the
plain version, `emit_plain`, for CPU tensors: `encode_dynamic.
emit_pack_plain` with tables, `encode_v2.emit_static_plain` without.
Both give the same four outputs, every padding byte of the rows
included; the kernel's source notes its design (a persistent grid of
blocks taking tiles of 64 rows in ticket order, the tiles' rows staged
by bulk copies, a tile's base by a look-back a step later, in one
launch).

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
#: the kernel's state per (device, stream): zeroed once, left zeroed by
#: every launch
_STATE: dict[tuple[int, int], torch.Tensor] = {}
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("emit")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = [p, ll, p, ll, p, ll, p, ll, p, ll, p, p, p, i, i, p, p, p, p,
                p]
        lib.ldrsx_emit.argtypes = [*args, p]
        lib.ldrsx_emit.restype = i
        lib.ldrsx_emit_shaped.argtypes = [*args, i, p, p]
        lib.ldrsx_emit_shaped.restype = i
        lib.ldrsx_emit_scratch.argtypes = [i, i]
        lib.ldrsx_emit_scratch.restype = ll
        lib.ldrsx_emit_shape.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.ldrsx_emit_shape.restype = i
        _LIB = lib
    return _LIB


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


def launch_shape(b: int, block_size: int, dynamic: bool = True,
                 device=None) -> dict:
    """The kernel's launch on b blocks of block_size lanes on the card:
    lanes a tile, blocks launched, blocks resident an SM, registers a
    thread and dynamic shared memory of a block in bytes. Raises if the
    kernel does not take it."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = _lib().ldrsx_emit_shape(b, block_size // ROW, int(dynamic), out)
    if rc != 0:
        raise RuntimeError(f"emit kernel: no launch shape for {b} blocks of "
                           f"{block_size} lanes (CUDA error {rc})")
    return dict(zip(("tile", "blocks", "resident", "registers", "shared"),
                    out))


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """x itself when its lanes are contiguous (the kernel takes any row
    stride and alignment, so a column slice needs no copy), else a
    contiguous copy."""
    if x.stride(1) == 1:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _round_ok(x: torch.Tensor, s: int) -> bool:
    """Whether the kernel may read x's rows of s bytes rounded out to 16
    bytes: they start on 16 bytes (nothing to round), or the first row's
    start rounded down and the last row's end rounded up stay inside x's
    storage."""
    first, stride = x.data_ptr(), x.stride(0)
    if first % 16 == 0 and stride % 16 == 0:
        return True
    storage = x.untyped_storage()
    end = first + (x.shape[0] - 1) * stride + s
    return first - first % 16 >= storage.data_ptr() and \
        -(-end // 16) * 16 <= storage.data_ptr() + storage.nbytes()


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The current stream of device `index`, as a pointer."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def _state(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The zeroed state of the kernel's launches on this stream, at least
    nbytes; a larger one replaces it when needed."""
    key = (dev.index, stream)
    st = _STATE.get(key)
    if st is None or st.numel() < nbytes:
        size = max(nbytes, 0 if st is None else 2 * st.numel())
        st = _STATE[key] = torch.zeros(size, dtype=torch.uint8, device=dev)
    return st


def _launch(dev, b: int, r: int, args, rnd: int) -> int:
    """The C call on the current device's current stream, with that
    stream's state; returns its CUDA error code."""
    stream = _stream(dev.index)
    # ldrsx_emit_scratch's bytes: two counters, a word a tile of 64 rows
    state = _state(dev, stream, 8 + 8 * b * -(-r // 64))
    return _lib().ldrsx_emit_shaped(*args, state.data_ptr(), rnd, None,
                                    stream)


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
    if ml.dim() != 2 or s <= 0 or s % ROW \
            or ml.shape != (b, s) or dist.shape != (b, s) \
            or sel.shape != (b, s) or lit.shape != (b, s) \
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
    if data.stride(1) != 1 or ml.stride(1) != 1 or dist.stride(1) != 1 \
            or sel.stride(1) != 1 or lit.stride(1) != 1:
        data, ml, dist, sel, lit = map(_lanes, (data, ml, dist, sel, lit))
    start = None
    if dyn:
        ll_tab, of_tab = (t if t.dtype == torch.int32 and t.is_contiguous()
                          and t.device == dev else
                          t.to(device=dev, dtype=torch.int32).contiguous()
                          for t in (ll_tab, of_tab))
        start = start_bits if start_bits.dtype == torch.int64 \
            and start_bits.is_contiguous() and start_bits.device == dev \
            else start_bits.to(device=dev, dtype=torch.int64).contiguous()
    args = (data.data_ptr(), data.stride(0), ml.data_ptr(), ml.stride(0),
            dist.data_ptr(), dist.stride(0), sel.data_ptr(), sel.stride(0),
            lit.data_ptr(), lit.stride(0),
            ll_tab.data_ptr() if dyn else None,
            of_tab.data_ptr() if dyn else None,
            start.data_ptr() if dyn else None, b, r,
            rows.data_ptr(), byte_off.data_ptr(), row_bit0.data_ptr(),
            end_bits.data_ptr())
    rnd = _round_ok(sel, s) | _round_ok(lit, s) << 1 | _round_ok(data, s) << 2
    if dev.index == torch.cuda.current_device():
        rc = _launch(dev, b, r, args, rnd)
    else:
        with torch.cuda.device(dev):
            rc = _launch(dev, b, r, args, rnd)
    if rc != 0:
        raise RuntimeError(f"emit kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
