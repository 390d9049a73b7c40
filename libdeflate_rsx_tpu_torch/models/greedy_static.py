"""Level-1 tier of the device encoder: greedy parse + static Huffman.

Port of `libdeflate_rsx_tpu/models/greedy_static.py`. Blocks are encoded
independently on the device (ops/encode_v2.encode_rows_static) and
joined byte-aligned by SYNC markers, so the block streams concatenate
into one DEFLATE stream. The device also places the row buffers
(ops/assemble.py), gives a block whose static stream would expand past
the stored cost stored blocks instead, and joins the blocks, so one
buffer per pass crosses to the host. The output is byte-identical to
the JAX package's for the same input and block size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import budget
from ..ops.assemble import Inputs, assemble, split_parts, static_layout
from ..ops.encode_v2 import BLOCK_PAD, encode_rows_static

DEFAULT_BLOCK = 65536
_OUT_FACTOR = 1.25

#: None, or a callable that the device encode flows (here and in
#: models/greedy_dynamic.py) call with each phase's name as the phase
#: ends; scripts/phase_probe_torch.py times the phases with it
PHASE_END = None


def _phase_end(name: str) -> None:
    if PHASE_END is not None:
        PHASE_END(name)


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


def static_pass(arr, valid, finals, block_size: int, device) -> Inputs:
    """Block rows encoded on `device` in one pass: the pass's inputs to
    the assembly (ops/assemble.Inputs), every tensor on the device."""
    arr_t, valid_t, finals_t = (torch.from_numpy(x).to(device)
                                for x in (arr, valid, finals))
    _phase_end("h2d")
    rows, byte_off, rowbits, total_bits, _ = encode_rows_static(
        arr_t, valid_t, finals_t, block_size)
    _phase_end("encode")
    return Inputs(rows, byte_off,
                  *static_layout(rowbits, total_bits, finals_t), finals_t,
                  arr_t, valid_t, int(block_size * _OUT_FACTOR) + 64)


def finish_pass(inputs: Inputs) -> list[bytes]:
    """A pass's rows assembled on their device (a block whose stream
    would expand past its stored cost takes stored blocks of its raw
    bytes) and joined, then copied to the host once: one bytes per
    row."""
    joined, sizes = assemble(*inputs)
    _phase_end("assemble")
    parts = split_parts(joined, sizes)
    _phase_end("d2h")
    return parts


def static_rows(arr, valid, finals, block_size: int, device) -> list[bytes]:
    """Block rows encoded, assembled and joined on `device` in one pass:
    one bytes per row."""
    return finish_pass(static_pass(arr, valid, finals, block_size, device))


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
    return b"".join(part for a, b in spans for part in static_rows(
        arr[a:b], valid[a:b], finals[a:b], block_size, device))
