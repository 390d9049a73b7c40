"""Level-1 tier of the device encoder: greedy parse + static Huffman.

Port of `libdeflate_rsx_tpu/models/greedy_static.py`. Blocks are encoded
independently on the device (ops/encode_v2.encode_rows_static) and
joined byte-aligned by SYNC markers, so the block streams concatenate
into one DEFLATE stream; the host places the row buffers and gives a
block whose static stream would expand past the stored cost stored
blocks instead. The output is byte-identical to the JAX package's for
the same input and block size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import budget
from ..ops.encode_v2 import BLOCK_PAD, assemble_blocks, encode_rows_static

DEFAULT_BLOCK = 65536
_OUT_FACTOR = 1.25
MAX_STORED = 65535

#: None, or a callable that the device encode flows (here and in
#: models/greedy_dynamic.py) call with each phase's name as the phase
#: ends; scripts/phase_probe_torch.py times the phases with it
PHASE_END = None


def _phase_end(name: str) -> None:
    if PHASE_END is not None:
        PHASE_END(name)


def _stored_block(raw: bytes, final: bool) -> bytes:
    """Byte-aligned stored block(s) for one chunk (RFC 1951 3.2.4)."""
    out = bytearray()
    n = len(raw)
    pos = 0
    while True:
        chunk = min(n - pos, MAX_STORED)
        last = pos + chunk == n
        out.append(1 if (final and last) else 0)   # BFINAL, BTYPE=00
        out += chunk.to_bytes(2, "little")
        out += ((~chunk) & 0xFFFF).to_bytes(2, "little")
        out += raw[pos:pos + chunk]
        pos += chunk
        if last:
            return bytes(out)


def split_blocks(data: bytes, block_size: int):
    """(padded_blocks (num, block_size + BLOCK_PAD) uint8, valid_lens,
    finals, num) for one buffer."""
    n = len(data)
    num = max(1, -(-n // block_size))
    arr = np.zeros((num, block_size + BLOCK_PAD), dtype=np.uint8)
    valid = np.zeros(num, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for i in range(num):
        lo = i * block_size
        hi = min(lo + block_size, n)
        arr[i, : hi - lo] = flat[lo:hi]
        valid[i] = hi - lo
    finals = np.zeros(num, bool)
    finals[-1] = True
    return arr, valid, finals, num


def apply_stored_fallback(parts: list[bytes], data: bytes,
                          block_size: int, valid: np.ndarray,
                          finals: np.ndarray, num: int) -> list[bytes]:
    """Per-block stored fallback: block i (at data[i * block_size:],
    valid[i] bytes) becomes stored blocks when its stream would expand
    past the stored cost."""
    for i in range(num):
        v = int(valid[i])
        stored_cost = v + 5 * max(1, -(-v // MAX_STORED))
        if len(parts[i]) > stored_cost:
            raw = data[i * block_size: i * block_size + v]
            parts[i] = _stored_block(raw, bool(finals[i]))
    return parts


def _assemble(device_out, finals, num: int, block_size: int) -> list[bytes]:
    """Host assembly of the device rows (numpy arrays): one bytes per
    block."""
    rows, byte_off, rowbits, total_bits, nbytes = (
        np.asarray(a) for a in device_out)
    out_cap = int(block_size * _OUT_FACTOR) + 64
    return assemble_blocks(rows, byte_off.astype(np.int64),
                           rowbits.astype(np.int64), total_bits,
                           nbytes, finals, num, out_cap)


def static_rows(arr, valid, finals, block_size: int, device) -> list[bytes]:
    """Block rows encoded on `device` in one pass and assembled on the
    host, before the stored fallback: one bytes per row."""
    args = [torch.from_numpy(x).to(device) for x in (arr, valid, finals)]
    _phase_end("h2d")
    out = encode_rows_static(*args, block_size)
    _phase_end("encode")
    out = [t.cpu().numpy() for t in out]
    _phase_end("d2h")
    parts = _assemble(out, finals, len(arr), block_size)
    _phase_end("assemble")
    return parts


def encode_window(metas, payload, finals, spans, block_size: int,
                  encode) -> list[bytes]:
    """Rows of a stacked batch of items, encoded pass by pass: for each
    [a, b) of `spans`, encode(a, b) gives rows a..b-1 assembled, and a
    row whose stream would expand past its stored cost becomes stored,
    read at its block's index in its own item. metas holds (first row,
    row count, data) per item, payload each row's bytes of its item.
    Returns one bytes per row of the spans, in order."""
    parts: list[bytes] = []
    for a, b in spans:
        got = encode(a, b)
        for start, num, data in metas:
            s, e = max(a, start), min(b, start + num)
            if s < e:
                parts += apply_stored_fallback(
                    got[s - a:e - a], data[(s - start) * block_size:],
                    block_size, payload[s:e], finals[s:e], e - s)
    return parts


def deflate_device_static(data: bytes, block_size: int = DEFAULT_BLOCK,
                          launch_rows: int | None = None,
                          device="cuda") -> bytes:
    """Whole-buffer raw-DEFLATE encode on the device (level-1 tier).

    launch_rows bounds how many blocks one device pass holds: a larger
    buffer is encoded in passes of that many blocks; without it, the
    memory budget (budget.py) sets the passes. Blocks are independent,
    so the bytes equal those of one pass."""
    arr, valid, finals, num = split_blocks(data, block_size)
    _phase_end("split")
    if launch_rows is None:
        spans = budget.passes("static", [arr.shape[1]] * num, device)
    else:
        spans = [(lo, min(lo + launch_rows, num))
                 for lo in range(0, num, launch_rows)]
    parts = encode_window(
        [(0, num, data)], valid, finals, spans, block_size,
        lambda a, b: static_rows(arr[a:b], valid[a:b], finals[a:b],
                                 block_size, device))
    return b"".join(parts)
