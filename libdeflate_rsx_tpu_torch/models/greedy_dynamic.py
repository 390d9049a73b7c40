"""Dynamic-Huffman tiers of the device encoder: whole buffers -> raw
DEFLATE.

Port of `libdeflate_rsx_tpu/models/greedy_dynamic.py`: the fast tier of
levels 4-5 (`deflate_device_dynamic[_many]`, blocks analyzed alone) and
the L6 ratio tier of levels 6-9 (`deflate_device_l6[_many]`, blocks
with a 32 KiB history prefix). Each block is analyzed, gets its code
tables (ops/dyn_tables.py), is emitted and is assembled
(ops/assemble.py) on the device; a block whose dynamic stream would
expand past the stored cost becomes stored blocks there, and the joined
streams are the one buffer per pass that crosses to the host. The
output is byte-identical to the JAX package's for the same input and
block size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import budget
from ..ops.assemble import Inputs
from ..ops.dyn_tables import build_tables
from ..ops.encode_dynamic import HIST, analyze_block, analyze_block_l6, emit_pack
from ..ops.encode_v2 import BLOCK_PAD
from .greedy_static import _phase_end, finish_pass, split_blocks

DEFAULT_BLOCK = 65536


def split_blocks_hist(data: bytes, block_size: int):
    """Blocks with a 32 KiB history prefix from the preceding payload:
    (arr (num, HIST + block_size + BLOCK_PAD) uint8, valid (num,),
    hist_start (num,), finals (num,), num)."""
    n = len(data)
    num = max(1, -(-n // block_size))
    s = HIST + block_size
    arr = np.zeros((num, s + BLOCK_PAD), np.uint8)
    valid = np.zeros(num, np.int32)
    hist_start = np.zeros(num, np.int32)
    flat = np.frombuffer(data, np.uint8)
    for i in range(num):
        lo = i * block_size
        hi = min(lo + block_size, n)
        h = min(HIST, lo)
        arr[i, HIST - h: HIST + hi - lo] = flat[lo - h:hi]
        valid[i] = HIST + hi - lo
        hist_start[i] = HIST - h
    finals = np.zeros(num, bool)
    finals[-1] = True
    return arr, valid, hist_start, finals, num


def emit_inputs(arr_t, valid_t, finals_t, block_size, hist_t=None):
    """Block rows on their device analyzed and given their tables, the
    pass up to its emit: (lanes (data, ml, dist, sel, lit), tables
    (ll_tabs, of_tabs, hdr_bits), hdr, histograms (ll (B, 288), of
    (B, 30))). With hist_t, the blocks carry a history prefix and take
    the L6 analysis, and data is the rows' payload columns."""
    if hist_t is None:
        analyzed = analyze_block(arr_t, valid_t, block_size)
    else:
        analyzed = analyze_block_l6(arr_t, valid_t, hist_t, block_size)
        arr_t = arr_t[:, HIST:]
    ml, dist, sel, lit, llh, ofh = analyzed
    _phase_end("analyze")
    ll_tabs, of_tabs, hdr, hdr_bits = build_tables(llh, ofh, finals_t)
    _phase_end("tables")
    return (arr_t, ml, dist, sel, lit), (ll_tabs, of_tabs, hdr_bits), hdr, \
        (llh, ofh)


def dynamic_pass(arr, valid, finals, block_size, device, hist_start=None):
    """Block rows analyzed, given their tables and emitted on `device`
    in one pass. With hist_start, the blocks carry a history prefix and
    take the L6 analysis. Returns the pass's inputs to the assembly
    (ops/assemble.Inputs) and its histograms (ll (B, 288), of (B, 30)),
    the table step's inputs; every tensor on the device."""
    arr_t, valid_t, finals_t = (torch.from_numpy(x).to(device)
                                for x in (arr, valid, finals))
    hist_t = None if hist_start is None else \
        torch.from_numpy(hist_start).to(device)
    _phase_end("h2d")
    lanes, tables, hdr, hists = emit_inputs(arr_t, valid_t, finals_t,
                                            block_size, hist_t)
    ll_tabs, of_tabs, hdr_bits = tables
    rows, byte_off, row_bit0, end_bits = emit_pack(*lanes, *tables,
                                                   block_size)
    _phase_end("emit")
    raw_len = valid_t if hist_t is None else valid_t - HIST
    return Inputs(rows, byte_off, row_bit0, end_bits, hdr, hdr_bits,
                  ll_tabs[:, 256], finals_t, lanes[0], raw_len,
                  2 * block_size + 1024), hists


def _encode_blocks(arr, valid, finals, block_size, device,
                   hist_start=None):
    """Shared flow, all on `device`: analyze -> tables -> emit ->
    assembly, stored fallback and join; one copy to the host. Returns
    one bytes per row."""
    return finish_pass(dynamic_pass(arr, valid, finals, block_size, device,
                                    hist_start)[0])


def split_many(datas: list[bytes], block_size: int, history: bool,
               final: bool = True):
    """Every item's block rows, stacked: (metas [(first row, row
    count)], arr, valid, hist_start (None without history), finals).
    With history (the L6 tier) each row carries its own prefix from its
    own item; final=False leaves every block non-final (SYNC-joined)."""
    metas, blocks = [], []
    row = 0
    for data in datas:
        if history:
            arr, valid, hist_start, finals, num = split_blocks_hist(
                data, block_size)
        else:
            arr, valid, finals, num = split_blocks(data, block_size)
            hist_start = None
        if not final:
            finals[:] = False
        metas.append((row, num))
        blocks.append((arr, valid, hist_start, finals))
        row += num
    if not metas:
        return [], None, None, None, None
    arr, valid, hist_start, finals = (
        None if parts[0] is None else np.concatenate(parts)
        for parts in zip(*blocks))
    return metas, arr, valid, hist_start, finals


def _encode_many(datas: list[bytes], block_size: int, device,
                 history: bool) -> list[bytes]:
    """Batched encode of many independent buffers: all items' blocks
    ride one analyze pass, one table step and one emit pass, or as few
    passes as the memory budget (budget.py) allows, split at block
    rows; history (the L6 tier) never crosses item bounds."""
    metas, arr, valid, hist_start, finals = split_many(datas, block_size,
                                                       history)
    if not metas:
        return []
    _phase_end("split")
    kind = "l6" if history else "dynamic"
    parts = [part for a, b in budget.passes(kind, [arr.shape[1]] * len(arr),
                                            device)
             for part in _encode_blocks(
                 arr[a:b], valid[a:b], finals[a:b], block_size, device,
                 None if hist_start is None else hist_start[a:b])]
    outs = [b"".join(parts[start:start + num]) for start, num in metas]
    _phase_end("join")
    return outs


def deflate_device_dynamic(data: bytes, block_size: int = DEFAULT_BLOCK,
                           device="cuda") -> bytes:
    """Whole-buffer raw-DEFLATE encode, dynamic-Huffman tier (levels
    4-5)."""
    return _encode_many([data], block_size, device, history=False)[0]


def deflate_device_dynamic_many(datas: list[bytes],
                                block_size: int = DEFAULT_BLOCK,
                                device="cuda") -> list[bytes]:
    """Batched dynamic-tier encode of many independent buffers in one
    analyze and one emit pass; equal to the per-item encodes."""
    return _encode_many(datas, block_size, device, history=False)


def deflate_device_l6(data: bytes, block_size: int = DEFAULT_BLOCK,
                      device="cuda") -> bytes:
    """Whole-buffer raw-DEFLATE encode, L6 ratio tier (levels 6-9)."""
    return _encode_many([data], block_size, device, history=True)[0]


def deflate_device_l6_many(datas: list[bytes],
                           block_size: int = DEFAULT_BLOCK,
                           device="cuda") -> list[bytes]:
    """Batched L6 encode of many independent buffers in one analyze and
    one emit pass; equal to the per-item encodes."""
    return _encode_many(datas, block_size, device, history=True)
