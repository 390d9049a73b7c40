"""Dynamic-Huffman tiers of the device encoder: whole buffers -> raw
DEFLATE.

Port of `libdeflate_rsx_tpu/models/greedy_dynamic.py`: the fast tier of
levels 4-5 (`deflate_device_dynamic[_many]`, blocks analyzed alone) and
the L6 ratio tier of levels 6-9 (`deflate_device_l6[_many]`, blocks
with a 32 KiB history prefix). Each block is analyzed on the device,
gets its code tables on the host, is emitted on the device, and is
assembled on the host. A block whose dynamic stream would expand past
the stored cost becomes stored blocks. The output is byte-identical to
the JAX package's for the same input and block size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import budget
from ..ops.encode_dynamic import (
    HIST,
    analyze_block,
    analyze_block_l6,
    build_tables_host,
    emit_pack,
)
from ..ops.encode_v2 import BLOCK_PAD
from .greedy_static import _phase_end, encode_window, split_blocks

DEFAULT_BLOCK = 65536


def _or_bits(buf: np.ndarray, bitpos: int, value: int, nbits: int) -> None:
    """OR `nbits` of `value` into buf starting at absolute bit `bitpos`."""
    if nbits <= 0:
        return
    v = value << (bitpos & 7)
    b = bitpos >> 3
    nby = ((bitpos & 7) + nbits + 7) // 8
    for k in range(nby):
        buf[b + k] |= (v >> (8 * k)) & 0xFF


def assemble_dynamic(device_out, headers, hdr_bits: np.ndarray,
                     ll_tabs: np.ndarray, finals: np.ndarray,
                     num: int, out_cap: int) -> list[bytes]:
    """Host assembly: header bytes + OR-placed device rows + EOB +
    final/SYNC trailer per block. device_out holds numpy arrays."""
    rows, byte_off, row_bit0, end_bits = (np.asarray(a) for a in device_out)
    byte_off = byte_off.astype(np.int64)
    row_bit0 = row_bit0.astype(np.int64)
    end_bits = end_bits.astype(np.int64)
    out = np.zeros((num, out_cap), dtype=np.uint8)
    for i in range(num):
        h = np.frombuffer(headers[i], np.uint8)
        out[i, : len(h)] = h

    nxt = np.concatenate([row_bit0[:, 1:], end_bits[:, None]], axis=1)
    bits_r = nxt - row_bit0
    extent = ((row_bit0 & 7) + bits_r + 7) // 8
    extent = np.minimum(extent, rows.shape[2])
    # the JAX package's native row assembly is absent: numpy places rows
    b, r, w = rows.shape
    kk = np.arange(w)[None, None, :]
    gidx = np.minimum(byte_off[:, :, None] + kk, out_cap - 1)
    use = kk < extent[:, :, None]
    bidx = np.broadcast_to(np.arange(b)[:, None, None], gidx.shape)
    np.bitwise_or.at(out, (bidx[use], gidx[use]), rows[use])

    parts: list[bytes] = []
    for i in range(num):
        ent = int(ll_tabs[i, 256])
        eob_code, eob_len = ent & 0xFFFF, ent >> 16
        end = int(end_bits[i])
        _or_bits(out[i], end, eob_code, eob_len)
        total = end + eob_len
        if finals[i]:
            nb = (total + 7) // 8
        else:
            # SYNC join: 3-bit empty-stored header (000) + byte align +
            # LEN/NLEN 00 00 FF FF
            nb = (total + 3 + 7) // 8 + 4
            out[i, nb - 4: nb] = (0, 0, 0xFF, 0xFF)
        parts.append(out[i, :nb].tobytes())
    return parts


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


def _encode_blocks(arr, valid, finals, block_size, device,
                  hist_start=None):
    """Shared flow: analyze (device) -> tables (host) -> emit (device)
    -> assemble (host). With hist_start, the blocks carry a history
    prefix and take the L6 analysis."""
    arr_t, valid_t = (torch.from_numpy(x).to(device) for x in (arr, valid))
    hist_t = None if hist_start is None else \
        torch.from_numpy(hist_start).to(device)
    _phase_end("h2d")
    if hist_t is None:
        analyzed = analyze_block(arr_t, valid_t, block_size)
    else:
        analyzed = analyze_block_l6(arr_t, valid_t, hist_t, block_size)
        arr_t = arr_t[:, HIST:]
    ml, dist, sel, lit, llh, ofh = analyzed
    _phase_end("analyze")
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(llh, ofh, finals)
    _phase_end("tables")
    device_out = emit_pack(
        arr_t, ml, dist, sel, lit,
        torch.from_numpy(ll_tabs.astype(np.int64)).to(device),
        torch.from_numpy(of_tabs.astype(np.int64)).to(device),
        torch.from_numpy(hdr_bits.astype(np.int64)).to(device), block_size)
    _phase_end("emit")
    device_out = [t.cpu().numpy() for t in device_out]
    _phase_end("d2h")
    out_cap = 2 * block_size + 1024
    parts = assemble_dynamic(device_out, headers, hdr_bits, ll_tabs,
                             finals, arr.shape[0], out_cap)
    _phase_end("assemble")
    return parts


def split_many(datas: list[bytes], block_size: int, history: bool,
               final: bool = True):
    """Every item's block rows, stacked: (metas [(first row, row count,
    data)], arr, valid, hist_start (None without history), finals,
    payload: each row's bytes of its item). With history (the L6 tier)
    each row carries its own prefix from its own item; final=False
    leaves every block non-final (SYNC-joined)."""
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
        metas.append((row, num, data))
        blocks.append((arr, valid, hist_start, finals))
        row += num
    if not metas:
        return [], None, None, None, None, None
    arr, valid, hist_start, finals = (
        None if parts[0] is None else np.concatenate(parts)
        for parts in zip(*blocks))
    return (metas, arr, valid, hist_start, finals,
            valid - HIST if history else valid)


def _encode_many(datas: list[bytes], block_size: int, device,
                 history: bool) -> list[bytes]:
    """Batched encode of many independent buffers: all items' blocks
    ride one analyze pass, one table step and one emit pass, or as few
    passes as the memory budget (budget.py) allows, split at block
    rows; history (the L6 tier) never crosses item bounds."""
    metas, arr, valid, hist_start, finals, payload = split_many(
        datas, block_size, history)
    if not metas:
        return []
    _phase_end("split")
    kind = "l6" if history else "dynamic"
    parts = encode_window(
        metas, payload, finals,
        budget.passes(kind, [arr.shape[1]] * len(arr), device), block_size,
        lambda a, b: _encode_blocks(
            arr[a:b], valid[a:b], finals[a:b], block_size, device,
            None if hist_start is None else hist_start[a:b]))
    outs = [b"".join(parts[start:start + num]) for start, num, _ in metas]
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
