"""Block assembly of the device encoder on the device: row buffers ->
each block's DEFLATE stream -> the streams joined, stored fallback
included, in one kernel launch.

Counterpart of the JAX package's host tail of its L1-9 device encoders:
`native/assemble.c` `assemble_rows` (numpy's `bitwise_or.at` where that
library does not build) with the per-block tail of its numpy assemblers
(`ops/encode_v2.assemble_blocks`, `models/greedy_dynamic.assemble_dynamic`:
header, EOB, SYNC trailer) and the stored fallback of
`models/greedy_static` / `greedy_dynamic`. One kernel in
`csrc/assemble_rows.cu` does it on the card; `place_rows_plain` and
`join_rows_plain` are its plain PyTorch versions. The wrappers take the
kernel for CUDA tensors and the plain versions for CPU tensors.

A block's stream: the header bytes first (`hdr_bits` of them; the static
tier's is the 3-bit BFINAL | BTYPE=01), the rows ORed in at `byte_off`,
each over the bytes its bits span (`row_bit0` to the next row's, the
last to `end_bits`; at most the row width), the EOB code (`eob`: code |
len << 16) at `end_bits`, and for a non-final block the SYNC trailer (an
empty stored block, `00 00 FF FF` byte-aligned). A block whose stream
would pass `out_cap` gets byte count -1, and the join raises on it.

The join turns a block whose stream is longer than its stored form
(`v + 5 * ceil(v / 65535)` bytes for `v` raw bytes, at least one chunk)
into stored blocks of its raw bytes, and places the blocks end to end at
the exclusive scan of their sizes.

- `assemble` (the encode flows' call): on the card one launch builds
  each block's stream in shared memory, takes its offset from a
  single-pass scan and writes it, or its stored form, into a joined
  buffer allocated beforehand at a capacity the host knows without a
  sync (`joined_capacity`: no block's joined size passes its stored
  cost). Then one copy brings the byte counts and sizes to the host,
  which raises on -1 and cuts the buffer to their sum.
- `place_rows`: each block's stream alone, in row b of a (B, >= out_cap)
  buffer (the same kernel, without the join).
- `join_rows`: streams placed so, joined (the same kernel, reading the
  placed rows).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

MAX_STORED = 65535

#: kernel launches made by `assemble`, `place_rows` and `join_rows` (one
#: per assembled pass; the plain versions do not count)
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


_POINTERS = ("rows", "byte_off", "row_bit0", "end_bits", "hdr", "hdr_bits",
             "eob", "finals", "placed", "placed_nbytes", "raw", "raw_len",
             "scratch", "out", "joined", "scan", "info")
_WIDE = ("out_cap", "placed_pitch", "raw_stride", "buf_words", "out_pitch",
         "eob_stride")
_INTS = ("nblocks", "nrows", "width", "hdr_cap")


class _Args(ctypes.Structure):
    """The kernel's arguments (csrc/assemble_rows.cu `Args`)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int64) for n in _WIDE]
                + [(n, ctypes.c_int) for n in _INTS])


def _lib():
    lib = _build.load("assemble_rows")
    if lib.ldrsx_assemble.argtypes is None:
        lib.ldrsx_assemble.argtypes = [ctypes.POINTER(_Args),
                                       ctypes.c_void_p]
        lib.ldrsx_assemble.restype = ctypes.c_int
        lib.ldrsx_assemble_smem_limit.argtypes = [ctypes.c_int]
        lib.ldrsx_assemble_smem_limit.restype = ctypes.c_int
    return lib


_SMEM: dict[int, int] = {}
#: each (device, stream)'s scan state: a ticket, a count and one status
#: word per block, zeros between launches (the kernel's last thread
#: block clears them)
_SCAN: dict[tuple[int, int], torch.Tensor] = {}


def smem_limit(dev: torch.device) -> int:
    """Bytes of shared memory the kernel's thread block can take on the
    card: a stream up to this size is built there, a longer one in a
    global scratch row."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMEM:
        limit = _lib().ldrsx_assemble_smem_limit(idx)
        if limit < 0:
            raise RuntimeError("assemble: the card's shared memory limit "
                               "could not be read")
        _SMEM[idx] = limit
    return _SMEM[idx]


def _scan_state(dev: torch.device, stream: int, nblocks: int):
    key = (dev.index, stream)
    state = _SCAN.get(key)
    if state is None or state.numel() < 2 + nblocks:
        state = torch.zeros(2 + max(nblocks, 1024), dtype=torch.int64,
                            device=dev)
        _SCAN[key] = state
    return state


def _launch(dev: torch.device, nblocks: int, **fields) -> None:
    """One launch of the kernel on the current stream."""
    global LAUNCHES
    args = _Args(nblocks=nblocks)
    for name, value in fields.items():
        setattr(args, name, value.data_ptr()
                if isinstance(value, torch.Tensor) else value)
    with torch.cuda.device(dev):
        rc = _lib().ldrsx_assemble(ctypes.byref(args), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"assemble kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def stored_cost(v: int) -> int:
    """Bytes of the stored form of v raw bytes: v plus 5 per chunk of at
    most 65,535 bytes, at least one chunk."""
    return v + 5 * max(1, -(-v // MAX_STORED))


def joined_capacity(nblocks: int, raw_width: int) -> int:
    """Bytes that hold every block's joined stream, known on the host
    without a sync: a block keeps its stream only where it is no longer
    than its stored cost, and a raw length is at most the raw rows'
    width."""
    return nblocks * stored_cost(raw_width)


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


def _check_place(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
                 finals) -> None:
    b, r, _ = rows.shape
    if rows.dtype != torch.uint8 or hdr.dtype != torch.uint8 \
            or byte_off.shape != (b, r) or row_bit0.shape != (b, r) \
            or hdr.shape[0] != b or any(x.shape != (b,) for x in (
                end_bits, hdr_bits, eob, finals)):
        raise ValueError("place_rows: rows and hdr must be uint8, with "
                         "(B, R) offsets and (B,) block fields")


def _row_fields(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits,
                eob) -> dict:
    """The kernel's row fields, in the types it reads (eob as it is laid
    out: the dynamic tiers' is a column of their litlen tables)."""
    i64, i32 = torch.int64, torch.int32
    eob = eob.to(i32)
    return dict(rows=rows.contiguous(), byte_off=byte_off.to(i64).contiguous(),
                row_bit0=row_bit0.to(i64).contiguous(),
                end_bits=end_bits.to(i64).contiguous(), hdr=hdr.contiguous(),
                hdr_bits=hdr_bits.to(i32).contiguous(), eob=eob,
                eob_stride=eob.stride(0), nrows=rows.shape[1],
                width=rows.shape[2], hdr_cap=hdr.shape[1])


def _bytes(flags):
    """A (B,) flag tensor as the kernel's uint8, without a copy for bool."""
    return (flags.view(torch.uint8) if flags.dtype == torch.bool
            else flags.to(torch.uint8)).contiguous()


def place_rows(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
               finals, out_cap: int):
    """(out (B, >= out_cap) uint8 with each block's stream from byte 0
    and zeros after it, nbytes (B,) int64, -1 for a block past out_cap),
    on the inputs' device (module docstring)."""
    _check_place(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
                 finals)
    if rows.device.type == "cpu":
        return place_rows_plain(rows, byte_off, row_bit0, end_bits, hdr,
                                hdr_bits, eob, finals, out_cap)
    dev = rows.device
    b = rows.shape[0]
    pitch = -(-out_cap // 4) * 4
    out = torch.empty((b, pitch), dtype=torch.uint8, device=dev)
    nbytes = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out, nbytes
    # a row past the shared-memory limit is built in place, in out
    _launch(dev, b, **_row_fields(rows, byte_off, row_bit0, end_bits, hdr,
                                  hdr_bits, eob),
            finals=_bytes(finals), out=out,
            out_pitch=pitch, out_cap=out_cap, buf_words=pitch // 4,
            scratch=out if pitch > smem_limit(dev) else None, info=nbytes)
    return out, nbytes


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


def _check_join(out, nbytes, raw, raw_len, finals) -> None:
    b = out.shape[0]
    if out.dtype != torch.uint8 or raw.dtype != torch.uint8 \
            or raw.shape[0] != b or any(x.shape != (b,) for x in (
                nbytes, raw_len, finals)):
        raise ValueError("join_rows: out and raw must be uint8 rows, with "
                         "(B,) block fields")


def _join_async(dev, b: int, raw, raw_len, finals, **fields):
    """The kernel's join launched on the card, with no host sync:
    (joined buffer of joined_capacity bytes, info (2, B) int64: byte
    counts, -1 past out_cap, and joined sizes), both on the device."""
    if raw.shape[1] > 1 and raw.stride(1) != 1:
        raise ValueError("join_rows: raw rows must be contiguous in bytes")
    joined = torch.empty(joined_capacity(b, raw.shape[1]), dtype=torch.uint8,
                         device=dev)
    info = torch.empty((2, b), dtype=torch.int64, device=dev)
    if b:
        _launch(dev, b, **fields, raw=raw, raw_stride=raw.stride(0),
                raw_len=raw_len.to(torch.int32).contiguous(),
                finals=_bytes(finals), joined=joined,
                scan=_scan_state(dev, _stream(dev), b), info=info)
    return joined, info


def _cut(joined, info):
    """One copy of the byte counts and sizes to the host; raises for a
    block past out_cap. Returns (the joined streams on the device, sizes
    (B,) int64 on the host)."""
    host = info.cpu().numpy()
    raise_past_cap(host[0])
    return joined[:int(host[1].sum())], host[1]


def join_rows(out, nbytes, raw, raw_len, finals):
    """(joined (sum of sizes,) uint8 on the device, sizes (B,) int64 on
    the host): the blocks' streams, placed in out (B, >= nbytes) uint8
    rows as `place_rows` gives them, or their stored forms read from raw
    (B, >= max raw_len) uint8 rows (a row may be a strided view), end to
    end. Raises if a block passed out_cap (nbytes -1)."""
    _check_join(out, nbytes, raw, raw_len, finals)
    if out.device.type == "cpu":
        return join_rows_plain(out, nbytes, raw, raw_len, finals)
    if out.stride(1) != 1 or out.stride(0) % 4 or out.data_ptr() % 4:
        raise ValueError("join_rows: out's rows must be contiguous in bytes "
                         "and 4-byte aligned, as place_rows gives them")
    return _cut(*_join_async(
        out.device, out.shape[0], raw, raw_len, finals, placed=out,
        placed_pitch=out.stride(0),
        placed_nbytes=nbytes.to(torch.int64).contiguous(),
        out_cap=out.shape[1]))


def join_rows_plain(out, nbytes, raw, raw_len, finals):
    """Plain version of the kernel's join, with tensor gathers, on any
    device: a block longer than its stored form takes the stored form;
    one copy of the byte counts and sizes to the host raises for a block
    that passed out_cap."""
    _check_join(out, nbytes, raw, raw_len, finals)
    dev = out.device
    v = raw_len.to(torch.int64)
    cost = v + 5 * ((v + MAX_STORED - 1) // MAX_STORED).clamp(min=1)
    stored = nbytes > cost
    sizes = torch.where(stored, cost, nbytes)
    host = torch.stack([nbytes, sizes]).cpu().numpy()
    raise_past_cap(host[0])
    offsets = torch.cumsum(sizes, 0) - sizes
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
    return joined, host[1]


def assemble(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob, finals,
             raw, raw_len, out_cap: int):
    """(joined streams on the device, each block's size on the host):
    place_rows then join_rows, in one kernel launch on the card (module
    docstring)."""
    _check_place(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
                 finals)
    if rows.device.type == "cpu":
        out, nbytes = place_rows_plain(rows, byte_off, row_bit0, end_bits,
                                       hdr, hdr_bits, eob, finals, out_cap)
        return join_rows_plain(out, nbytes, raw, raw_len, finals)
    return _cut(*assemble_async(rows, byte_off, row_bit0, end_bits, hdr,
                                hdr_bits, eob, finals, raw, raw_len, out_cap))


def assemble_async(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits, eob,
                   finals, raw, raw_len, out_cap: int):
    """`assemble`'s launch on the card, with no host sync: (joined
    buffer, info (2, B) int64 of byte counts, -1 past out_cap, and
    joined sizes), both on the device. CUDA tensors only."""
    dev = rows.device
    b = rows.shape[0]
    # a stream that is kept is no longer than its stored cost
    words = -(-min(out_cap, stored_cost(raw.shape[1])) // 4)
    scratch = None
    if b and 4 * words > smem_limit(dev):
        scratch = torch.empty(b * words, dtype=torch.int32, device=dev)
    return _join_async(dev, b, raw, raw_len, finals,
                       **_row_fields(rows, byte_off, row_bit0, end_bits, hdr,
                                     hdr_bits, eob),
                       out_cap=out_cap, buf_words=words, scratch=scratch)


def split_parts(joined: torch.Tensor, sizes: np.ndarray) -> list[bytes]:
    """One device-to-host copy of the joined streams, cut per block."""
    buf = joined.cpu().numpy().tobytes()
    ends = np.cumsum(sizes)
    return [buf[e - s:e] for s, e in zip(sizes.tolist(), ends.tolist())]
