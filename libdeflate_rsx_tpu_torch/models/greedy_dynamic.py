"""L6 ratio tier of the device encoder: whole buffers -> raw DEFLATE.

Port of the L6 path of `libdeflate_rsx_tpu/models/greedy_dynamic.py`,
with its JAX-free host helpers (`split_blocks_hist`, `assemble_dynamic`,
`apply_stored_fallback`, `_or_bits`, and `_stored_block` from
`greedy_static.py`) copied here, since the JAX modules that hold them
import JAX. Blocks carry a 32 KiB history prefix; each is analyzed on
the device, gets its code tables on the host, is emitted on the device,
and is assembled on the host. A block whose dynamic stream would expand
past the stored cost becomes stored blocks. The output is byte-identical
to the JAX package's for the same input and block size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.encode_dynamic import (
    HIST,
    analyze_block_l6,
    build_tables_host,
    emit_pack,
)
from ..ops.encode_v2 import BLOCK_PAD

DEFAULT_BLOCK = 65536
MAX_STORED = 65535

#: None, or a callable that the L6 flow calls with each phase's name as
#: the phase ends: split, h2d, analyze, tables, emit, d2h, assemble, join
#: (`deflate_device_l6` has no split and join); scripts/phase_probe_torch.py
#: times the phases with it
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


def apply_stored_fallback(parts: list[bytes], data: bytes,
                          block_size: int, valid: np.ndarray,
                          finals: np.ndarray, num: int) -> list[bytes]:
    """Per-block stored fallback when the dynamic stream expands."""
    for i in range(num):
        v = int(valid[i])
        stored_cost = v + 5 * max(1, -(-v // MAX_STORED))
        if len(parts[i]) > stored_cost:
            raw = data[i * block_size: i * block_size + v]
            parts[i] = _stored_block(raw, bool(finals[i]))
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


def _encode_l6_blocks(arr, valid, hist_start, finals, block_size, device):
    """Shared L6 flow: analyze (device) -> tables (host) -> emit (device)
    -> assemble (host)."""
    arr_t, valid_t, hist_t = (torch.from_numpy(x).to(device)
                              for x in (arr, valid, hist_start))
    _phase_end("h2d")
    ml, dist, sel, lit, llh, ofh = analyze_block_l6(
        arr_t, valid_t, hist_t, block_size)
    _phase_end("analyze")
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(llh, ofh, finals)
    _phase_end("tables")
    device_out = emit_pack(
        arr_t[:, HIST:], ml, dist, sel, lit,
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


def deflate_device_l6(data: bytes, block_size: int = DEFAULT_BLOCK,
                      device="cuda") -> bytes:
    """Whole-buffer raw-DEFLATE encode, L6 ratio tier."""
    arr, valid, hist_start, finals, num = split_blocks_hist(data, block_size)
    parts = _encode_l6_blocks(arr, valid, hist_start, finals, block_size,
                              device)
    return b"".join(apply_stored_fallback(
        parts, data, block_size, valid - HIST, finals, num))


def deflate_device_l6_many(datas: list[bytes],
                           block_size: int = DEFAULT_BLOCK,
                           device="cuda") -> list[bytes]:
    """Batched L6 encode of many independent buffers: all items'
    history-prefixed blocks ride one analyze pass, one table step and
    one emit pass; history never crosses item bounds."""
    metas = []
    arrs, valids, hists, finals_l = [], [], [], []
    row = 0
    for data in datas:
        arr, valid, hist_start, finals, num = split_blocks_hist(
            data, block_size)
        metas.append((row, num, data, finals))
        row += num
        arrs.append(arr)
        valids.append(valid)
        hists.append(hist_start)
        finals_l.append(finals)
    if not metas:
        return []
    arr = np.concatenate(arrs)
    valid = np.concatenate(valids)
    hist_start = np.concatenate(hists)
    finals = np.concatenate(finals_l)
    _phase_end("split")
    parts = _encode_l6_blocks(arr, valid, hist_start, finals, block_size,
                              device)
    outs = []
    for start, num, data, fin in metas:
        item_parts = apply_stored_fallback(
            parts[start:start + num], data, block_size,
            valid[start:start + num] - HIST, fin, num)
        outs.append(b"".join(item_parts))
    _phase_end("join")
    return outs
