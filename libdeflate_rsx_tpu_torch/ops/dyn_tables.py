"""Per-block dynamic-Huffman code tables and headers on the device.

Counterpart of the JAX package's host table step (`native/codec.c`
`dyn_tables_c` through `native/__init__.py` `dyn_tables_native`, with the
Python builder `_build_tables_py` where that library does not build).
The kernel, `csrc/dyn_tables.cu`, computes what `_build_tables_py`
computes, bit for bit: the JAX package runs that builder, and the C
builder gives other tables. `build_tables_plain` beside it is the plain
version: the same Python builder (`encode_dynamic.build_tables_host`)
taking and giving tensors of the kernel's shapes. `build_tables` takes
the kernel for CUDA tensors and the plain version for CPU tensors.

Inputs: `ll_hist (B, 288)` and `of_hist (B, 30)` symbol counts (the
uint16 histograms of `encode_dynamic._histograms`; the kernel takes no
other type), `finals (B,)` bool.
Outputs, on the inputs' device: `ll_tabs (B, 288)` and `of_tabs (B, 30)`
int32 entries `code | len << 16` (codes bit-reversed for LSB-first
emission), `hdr (B, HDR_CAP)` uint8 header bytes (BFINAL | BTYPE=10, then
the dynamic header, zero past its last bit) and `hdr_bits (B,)` int32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .encode_dynamic import NUM_LITLEN, NUM_OFFSET, build_tables_host

#: header bytes per block; a header takes at most ~300 (318 lengths of
#: at most 7 bits each, behind 74 bits of counts and precode lengths)
HDR_CAP = 512

#: kernel launches made by `build_tables` (the plain version does not
#: count)
LAUNCHES = 0


def _kernel_lib():
    fn = _build.load("dyn_tables").ldrsx_dyn_tables
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def _check(ll_hist, of_hist, finals) -> None:
    b = ll_hist.shape[0]
    if ll_hist.shape != (b, NUM_LITLEN) or of_hist.shape != (b, NUM_OFFSET) \
            or finals.shape != (b,):
        raise ValueError(
            f"build_tables: shapes {tuple(ll_hist.shape)}, "
            f"{tuple(of_hist.shape)}, {tuple(finals.shape)}; want (B, "
            f"{NUM_LITLEN}), (B, {NUM_OFFSET}), (B,)")
    if not (ll_hist.device == of_hist.device == finals.device):
        raise ValueError("build_tables: inputs on different devices")


def build_tables(ll_hist: torch.Tensor, of_hist: torch.Tensor,
                 finals: torch.Tensor):
    """(ll_tabs, of_tabs, hdr, hdr_bits) of each block (module
    docstring). CUDA tensors go to the CUDA kernel, CPU tensors to
    `build_tables_plain`."""
    global LAUNCHES
    _check(ll_hist, of_hist, finals)
    dev = ll_hist.device
    if dev.type == "cpu":
        return build_tables_plain(ll_hist, of_hist, finals)
    if ll_hist.dtype != torch.uint16 or of_hist.dtype != torch.uint16:
        raise ValueError("build_tables: the kernel takes uint16 histograms")
    fn = _kernel_lib()
    b = ll_hist.shape[0]
    llh, ofh = ll_hist.contiguous(), of_hist.contiguous()
    fin = (finals.view(torch.uint8) if finals.dtype == torch.bool
           else finals.to(torch.uint8)).contiguous()
    # the kernel writes every element of its outputs
    ll_tabs = torch.empty((b, NUM_LITLEN), dtype=torch.int32, device=dev)
    of_tabs = torch.empty((b, NUM_OFFSET), dtype=torch.int32, device=dev)
    hdr = torch.empty((b, HDR_CAP), dtype=torch.uint8, device=dev)
    hdr_bits = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return ll_tabs, of_tabs, hdr, hdr_bits
    with torch.cuda.device(dev):
        rc = fn(llh.data_ptr(), ofh.data_ptr(), fin.data_ptr(), b,
                ll_tabs.data_ptr(), of_tabs.data_ptr(), hdr.data_ptr(),
                hdr_bits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dyn_tables kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return ll_tabs, of_tabs, hdr, hdr_bits


def build_tables_plain(ll_hist: torch.Tensor, of_hist: torch.Tensor,
                       finals: torch.Tensor):
    """Plain version of the kernel: the Python package-merge builder
    per block, on the host, with the kernel's output shapes and types on
    the inputs' device."""
    _check(ll_hist, of_hist, finals)
    dev = ll_hist.device
    b = ll_hist.shape[0]
    ll_tabs, of_tabs, headers, hdr_bits = build_tables_host(
        ll_hist, of_hist, finals.cpu().numpy())
    hdr = np.zeros((b, HDR_CAP), np.uint8)
    for i, h in enumerate(headers):
        hdr[i, :len(h)] = np.frombuffer(h, np.uint8)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        ll_tabs.astype(np.int32), of_tabs.astype(np.int32), hdr,
        hdr_bits.astype(np.int32)))
