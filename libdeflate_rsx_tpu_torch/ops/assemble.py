"""Block assembly of the device encoder on the device: row buffers ->
each block's DEFLATE stream -> the streams joined, stored fallback
included.

Counterpart of the JAX package's host tail of its L1-9 device encoders:
`native/assemble.c` `assemble_rows` (numpy's `bitwise_or.at` where that
library does not build) with the per-block tail of its numpy assemblers
(`ops/encode_v2.assemble_blocks`, `models/greedy_dynamic.assemble_dynamic`:
header, EOB, SYNC trailer) and the stored fallback of
`models/greedy_static` / `greedy_dynamic`. Two kernels in
`csrc/assemble_rows.cu` do it on the card; `place_rows_plain` and
`join_rows_plain` beside them are their plain PyTorch versions. The
wrappers take the kernels for CUDA tensors and the plain versions for
CPU tensors.

`place_rows` ORs each block's rows into its stream: the header bytes
first (`hdr_bits` of them; the static tier's is the 3-bit BFINAL |
BTYPE=01), the rows at `byte_off`, each over the bytes its bits span
(`row_bit0` to the next row's, the last to `end_bits`; at most the row
width), the EOB code (`eob`: code | len << 16) at `end_bits`, and for a
non-final block the SYNC trailer (an empty stored block, `00 00 FF FF`
byte-aligned). A block whose stream would pass `out_cap` gets byte count
-1; `join_rows` raises on it.

`join_rows` turns a block whose stream is longer than its stored form
(`v + 5 * ceil(v / 65535)` bytes for `v` raw bytes, at least one chunk)
into stored blocks of its raw bytes, places the blocks end to end at the
exclusive scan of their sizes, and returns the joined buffer on the
device with the sizes on the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

MAX_STORED = 65535

#: kernel launches made by `place_rows` and `join_rows` (two per
#: assembled pass; the plain versions do not count)
LAUNCHES = 0


class Inputs(NamedTuple):
    """One device pass's inputs to `assemble`, in its argument order:
    the rows and their layout for `place_rows` (rows .. finals), each
    block's raw bytes and their count for the stored fallback of
    `join_rows`, and the streams' capacity."""
    rows: torch.Tensor
    byte_off: torch.Tensor
    row_bit0: torch.Tensor
    end_bits: torch.Tensor
    hdr: torch.Tensor
    hdr_bits: torch.Tensor
    eob: torch.Tensor
    finals: torch.Tensor
    raw: torch.Tensor
    raw_len: torch.Tensor
    out_cap: int


class JoinPlan(NamedTuple):
    """Each block's joined size, stored flag and offset (on the
    device), and the sizes on the host."""
    sizes: torch.Tensor
    stored: torch.Tensor
    offsets: torch.Tensor
    host: np.ndarray


def _lib():
    lib = _build.load("assemble_rows")
    if lib.ldrsx_place_rows.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ldrsx_place_rows.argtypes = [p] * 8 + [i] * 4 + [q, q] \
            + [p] * 4
        lib.ldrsx_place_rows.restype = ctypes.c_int
        lib.ldrsx_join_rows.argtypes = [p, q] + [p] * 4 + [q] + [p, p, i, q,
                                                             p, p]
        lib.ldrsx_join_rows.restype = ctypes.c_int
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def static_layout(rowbits: torch.Tensor, total_bits: torch.Tensor,
                  finals: torch.Tensor):
    """place_rows' (row_bit0, end_bits, hdr, hdr_bits, eob) for the
    static tier's rows (`encode_v2.encode_rows_static`): the rows follow
    the 3-bit header BFINAL | BTYPE=01, and the EOB is the 7-bit code 0."""
    rowbits = rowbits.to(torch.int64)
    b = rowbits.shape[0]
    dev = rowbits.device
    row_bit0 = 3 + torch.cumsum(rowbits, dim=1) - rowbits
    hdr = (finals.to(torch.uint8) | 0b010)[:, None]
    return (row_bit0, total_bits.to(torch.int64) - 7, hdr,
            torch.full((b,), 3, dtype=torch.int32, device=dev),
            torch.full((b,), 7 << 16, dtype=torch.int32, device=dev))


def row_extents(row_bit0: torch.Tensor, end_bits: torch.Tensor,
                width: int) -> torch.Tensor:
    """(B, R) bytes each row's bits span, from its first bit to the next
    row's (the last row's to end_bits), at most the row width."""
    nxt = torch.cat([row_bit0[:, 1:], end_bits[:, None]], dim=1)
    return (((row_bit0 & 7) + nxt - row_bit0 + 7) >> 3).clamp(max=width)


def place_rows(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
               finals, out_cap: int):
    """(out (B, >= out_cap) uint8 with each block's stream from byte 0,
    nbytes (B,) int64, -1 for a block past out_cap), on the inputs'
    device (module docstring)."""
    global LAUNCHES
    b, r, w = rows.shape
    if rows.dtype != torch.uint8 or hdr.dtype != torch.uint8 \
            or byte_off.shape != (b, r) or row_bit0.shape != (b, r) \
            or hdr.shape[0] != b or any(x.shape != (b,) for x in (
                end_bits, hdr_bits, eob, finals)):
        raise ValueError("place_rows: rows and hdr must be uint8, with "
                         "(B, R) offsets and (B,) block fields")
    if rows.device.type == "cpu":
        return place_rows_plain(rows, byte_off, row_bit0, end_bits, hdr,
                                hdr_bits, eob, finals, out_cap)
    dev = rows.device
    pitch = -(-out_cap // 4) * 4
    out = torch.zeros((b, pitch), dtype=torch.uint8, device=dev)
    nbytes = torch.empty(b, dtype=torch.int64, device=dev)
    status = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out, nbytes
    i64 = torch.int64
    args = [rows.contiguous(), byte_off.to(i64).contiguous(),
            row_bit0.to(i64).contiguous(), end_bits.to(i64).contiguous(),
            hdr.contiguous(), hdr_bits.to(torch.int32).contiguous(),
            eob.to(torch.int32).contiguous(),
            finals.to(torch.uint8).contiguous()]
    with torch.cuda.device(dev):
        rc = _lib().ldrsx_place_rows(
            *(a.data_ptr() for a in args), b, r, w, hdr.shape[1], out_cap,
            pitch, out.data_ptr(), nbytes.data_ptr(), status.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"place_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, torch.where(status != 0, -1, nbytes)


def place_rows_plain(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits,
                     eob, finals, out_cap: int):
    """Plain version of the place kernel: every byte added into an int32
    row by scatter_add_ (the bits of the rows, header, EOB and trailer
    are disjoint, so adding ORs them), on any device."""
    dev = rows.device
    i64 = torch.int64
    b, r, w = rows.shape
    byte_off, row_bit0, end_bits = (x.to(i64) for x in
                                    (byte_off, row_bit0, end_bits))
    finals = finals.to(torch.bool)
    extent = row_extents(row_bit0, end_bits, w)
    eob = eob.to(i64)
    code, ln = eob & 0xFFFF, eob >> 16
    total = end_bits + ln                   # the stream ends after its EOB
    nbytes = torch.where(finals, (total + 7) >> 3, ((total + 10) >> 3) + 4)
    over = ((byte_off + extent > out_cap) & (extent > 0)).any(dim=1) \
        | (nbytes > out_cap)
    acc = torch.zeros((b, out_cap + 1), dtype=torch.int32, device=dev)

    def add(idx, val, use):
        """Add val at idx (B, n) where use, into the spare last column
        elsewhere and past out_cap."""
        use = use & (idx >= 0) & (idx < out_cap)
        acc.scatter_add_(1, torch.where(use, idx, out_cap),
                         torch.where(use, val, 0).to(torch.int32))

    k = torch.arange(w, device=dev)
    add((byte_off[:, :, None] + k).reshape(b, r * w),
        rows.reshape(b, r * w), (k < extent[:, :, None]).reshape(b, r * w))
    j = torch.arange(hdr.shape[1], device=dev)
    add(j.expand(b, -1), hdr, j < ((hdr_bits.to(i64) + 7) >> 3)[:, None])
    v = code << (end_bits & 7)
    span = ((end_bits & 7) + ln + 7) >> 3
    for q in range(3):
        add(((end_bits >> 3) + q)[:, None], ((v >> (8 * q)) & 0xFF)[:, None],
            (q < span)[:, None])
    for back in (2, 1):
        add((nbytes - back)[:, None],
            torch.full((b, 1), 0xFF, dtype=i64, device=dev), ~finals[:, None])
    out = acc[:, :out_cap].to(torch.uint8)
    return out, torch.where(over, -1, nbytes)


def raise_past_cap(nbytes: np.ndarray) -> None:
    """Raise ValueError if a block's byte count (on the host) is -1,
    the mark of a stream past out_cap."""
    bad = np.flatnonzero(nbytes < 0)
    if len(bad):
        raise ValueError(
            f"blocks {bad[:10].tolist()} of the batch pass the output "
            "capacity")


def join_plan(nbytes, raw_len) -> JoinPlan:
    """A block longer than its stored form takes the stored form; the
    blocks' sizes, flags and offsets, with one copy of the byte counts
    and sizes to the host. Raises for a block that passed out_cap."""
    v = raw_len.to(torch.int64)
    cost = v + 5 * ((v + MAX_STORED - 1) // MAX_STORED).clamp(min=1)
    stored = nbytes > cost
    sizes = torch.where(stored, cost, nbytes)
    host = torch.stack([nbytes, sizes]).cpu().numpy()
    raise_past_cap(host[0])
    return JoinPlan(sizes, stored, torch.cumsum(sizes, 0) - sizes, host[1])


def _check_join(out, nbytes, raw, raw_len, finals) -> None:
    b = out.shape[0]
    if out.dtype != torch.uint8 or raw.dtype != torch.uint8 \
            or raw.shape[0] != b or any(x.shape != (b,) for x in (
                nbytes, raw_len, finals)):
        raise ValueError("join_rows: out and raw must be uint8 rows, with "
                         "(B,) block fields")


def join_rows(out, nbytes, raw, raw_len, finals):
    """(joined (sum of sizes,) uint8 on the device, sizes (B,) int64 on
    the host): the blocks' streams, or their stored forms read from raw
    (B, >= max raw_len) uint8 rows (a row may be a strided view),
    end to end. Raises if a block passed out_cap (nbytes -1)."""
    _check_join(out, nbytes, raw, raw_len, finals)
    if out.device.type == "cpu":
        return join_rows_plain(out, nbytes, raw, raw_len, finals)
    plan = join_plan(nbytes, raw_len)
    return join_planned(out, raw, raw_len, finals, plan), plan.host


def join_planned(out, raw, raw_len, finals, plan: JoinPlan):
    """The join kernel's launch on a plan from `join_plan`, with no
    host sync: the joined streams on the device."""
    global LAUNCHES
    dev = out.device
    total = int(plan.host.sum())
    joined = torch.empty(total, dtype=torch.uint8, device=dev)
    if total == 0:
        return joined
    if out.stride(1) != 1 or raw.stride(1) != 1:
        raise ValueError("join_rows: rows must be contiguous in bytes")
    args = (plan.sizes, plan.offsets, plan.stored.to(torch.uint8))
    raw_len = raw_len.to(torch.int64).contiguous()
    fin = finals.to(torch.uint8).contiguous()
    with torch.cuda.device(dev):
        rc = _lib().ldrsx_join_rows(
            out.data_ptr(), out.stride(0), *(a.data_ptr() for a in args),
            raw.data_ptr(), raw.stride(0), raw_len.data_ptr(), fin.data_ptr(),
            out.shape[0], int(plan.host.max()), joined.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"join_rows kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return joined


def join_rows_plain(out, nbytes, raw, raw_len, finals):
    """Plain version of the join kernel, with tensor gathers, on any
    device."""
    _check_join(out, nbytes, raw, raw_len, finals)
    dev = out.device
    sizes, stored, offsets, host = join_plan(nbytes, raw_len)
    b = out.shape[0]
    bid = torch.repeat_interleave(torch.arange(b, device=dev), sizes)
    t = torch.arange(bid.shape[0], device=dev) - offsets[bid]
    v = raw_len.to(torch.int64)[bid]
    nchunks = ((v + MAX_STORED - 1) // MAX_STORED).clamp(min=1)
    c, q = t // (MAX_STORED + 5), t % (MAX_STORED + 5)
    n = torch.clamp(v - c * MAX_STORED, max=MAX_STORED)
    last = finals.to(torch.bool)[bid] & (c == nchunks - 1)
    body = raw[bid, (c * MAX_STORED + q - 5).clamp(0, raw.shape[1] - 1)]
    head = torch.stack([last.to(torch.int64), n & 0xFF, (n >> 8) & 0xFF,
                        ~n & 0xFF, (~n >> 8) & 0xFF], dim=1)
    as_stored = torch.where(q < 5, head.gather(1, q.clamp(max=4)[:, None])[:, 0],
                            body.to(torch.int64))
    streamed = out[bid, t.clamp(max=out.shape[1] - 1)].to(torch.int64)
    joined = torch.where(stored[bid], as_stored, streamed).to(torch.uint8)
    return joined, host


def assemble(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob, finals,
             raw, raw_len, out_cap: int):
    """place_rows then join_rows: (joined streams on the device, each
    block's size on the host)."""
    out, nbytes = place_rows(rows, byte_off, row_bit0, end_bits, hdr,
                             hdr_bits, eob, finals, out_cap)
    return join_rows(out, nbytes, raw, raw_len, finals)


def split_parts(joined: torch.Tensor, sizes: np.ndarray) -> list[bytes]:
    """One device-to-host copy of the joined streams, cut per block."""
    buf = joined.cpu().numpy().tobytes()
    ends = np.cumsum(sizes)
    return [buf[e - s:e] for s, e in zip(sizes.tolist(), ends.tolist())]
