"""Closed-form DEFLATE code arithmetic (RFC 1951 3.2.5-3.2.6), elementwise.

Port of `libdeflate_rsx_tpu/ops/static_codes.py`. Values that the JAX
package holds as uint32 are held here in int64 tensors: every result
fits in 32 bits, and int64 shifts right logically on non-negative values,
as uint32 does.
"""

from __future__ import annotations

import torch

_I64 = torch.int64


def bitrev16(v: torch.Tensor) -> torch.Tensor:
    """Reverse the low 16 bits of each element."""
    v = v.to(_I64)
    v = ((v & 0x5555) << 1) | ((v & 0xAAAA) >> 1)
    v = ((v & 0x3333) << 2) | ((v & 0xCCCC) >> 2)
    v = ((v & 0x0F0F) << 4) | ((v & 0xF0F0) >> 4)
    v = ((v & 0x00FF) << 8) | ((v & 0xFF00) >> 8)
    return v


def bitrev(v: torch.Tensor, nbits) -> torch.Tensor:
    """Reverse the low `nbits` (<= 16) of v: DEFLATE codes are emitted
    MSB-first into an LSB-first stream."""
    return bitrev16(v) >> (16 - torch.as_tensor(nbits, dtype=_I64,
                                                device=v.device))


def bsr(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit via the float32 exponent (exact for
    1 <= x < 2^24), the same arithmetic as the JAX package."""
    f = torch.clamp(x.to(_I64), min=1).to(torch.float32)
    e = f.view(torch.int32).to(_I64) >> 23
    return (e & 0xFF) - 127


def literal_code(byte: torch.Tensor):
    """(code, nbits) of a literal byte under the static litlen code."""
    b = byte.to(_I64)
    hi = b >= 144
    nbits = torch.where(hi, 9, 8)
    v = torch.where(hi, 0x190 + (b - 144), 0x30 + b)
    return bitrev(v, nbits), nbits


def length_sym_fields(length: torch.Tensor):
    """(symbol 257..285, extra_val, extra_nbits) for match length 3..258."""
    n = length.to(_I64) - 3
    eb_big = bsr(n) - 2
    eb = torch.where(n < 8, 0, torch.clamp(eb_big, min=0))
    idx_big = (eb << 2) + (n >> torch.clamp(eb, min=0))
    idx = torch.where(n < 8, n, idx_big)
    extra = n & ((1 << eb) - 1)
    is258 = length == 258
    idx = torch.where(is258, 28, idx)
    eb = torch.where(is258, 0, eb)
    extra = torch.where(is258, 0, extra)
    return 257 + idx, extra, eb


def length_fields(length: torch.Tensor):
    """(sym_code, sym_nbits, extra_val, extra_nbits) for match length
    3..258 under the static code."""
    sym, extra, eb = length_sym_fields(length)
    sym8 = sym >= 280
    nbits = torch.where(sym8, 8, 7)
    v = torch.where(sym8, 0xC0 + (sym - 280), sym - 256)
    return bitrev(v, nbits), nbits, extra, eb


def offset_sym_fields(dist: torch.Tensor):
    """(symbol 0..29, extra_val, extra_nbits) for offset 1..32768."""
    o = dist.to(_I64) - 1
    b = bsr(o)
    hi = 2 * b + ((o >> torch.clamp(b - 1, min=0)) & 1)
    sym = torch.where(o < 4, o, hi)
    eb = torch.clamp(torch.div(sym, 2, rounding_mode="floor") - 1, min=0)
    base = torch.where(sym < 4, sym, ((2 + (sym & 1)) << eb) - 2 + 2)
    extra = o - base
    return sym, extra, eb


def offset_fields(dist: torch.Tensor):
    """(sym_code5, extra_val, extra_nbits) for offset 1..32768 under the
    static code (5-bit bit-reversed symbol)."""
    sym, extra, eb = offset_sym_fields(dist)
    return bitrev(sym, 5), extra, eb


def match_token(length: torch.Tensor, dist: torch.Tensor):
    """Fused (value, nbits) of a <length, dist> match token under the
    static code: lencode | lenextra | offcode | offextra, <= 31 bits."""
    lc, ln, lev, leb = length_fields(length)
    oc, oev, oeb = offset_fields(dist)
    v = lc
    nb = ln
    v = v | (lev << nb)
    nb = nb + leb
    v = v | (oc << nb)
    nb = nb + 5
    v = v | (oev << nb)
    nb = nb + oeb
    return v, nb
