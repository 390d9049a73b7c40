"""Pass 2 of the two-pass decoder: LZ copy resolution by pointer doubling.

Port of `libdeflate_rsx_tpu/ops/resolve.py::resolve_batch_jax`, as plain
PyTorch on either device. For each stream, every output position finds
the token that covers it (a binary search in the token start offsets),
points at its source (`p - dist` inside a match, itself at a literal),
and pointer doubling walks every position to its root literal in
ceil(log2(chain depth)) gather rounds. A final gather reads the bytes.
"""

from __future__ import annotations

import math

import torch

from .tokens import KIND_SHIFT

__all__ = ["resolve_batch"]


def resolve_batch(tokens: torch.Tensor, out_cap: int):
    """tokens (B, T) int32 -> (bytes (B, out_cap) uint8, outlen (B,) int32,
    ok (B,) bool), on the tokens' device.

    `ok` is False when a stream's tokens write past out_cap or a match
    reaches before the start of its output. Positions past a stream's
    outlen hold unspecified bytes; callers slice to outlen. NOP tokens
    (kind 0) may appear anywhere and emit nothing.
    """
    tokens = tokens.to(torch.int32)
    if tokens.shape[1] == 0:
        tokens = torch.zeros((tokens.shape[0], 1), dtype=torch.int32,
                             device=tokens.device)
    B, T = tokens.shape
    N = out_cap
    dev = tokens.device
    kind = (tokens >> KIND_SHIFT) & 3
    is_lit = kind == 1
    is_match = kind == 2
    ext = torch.where(is_match, (tokens & 0xFF) + 3, is_lit.to(torch.int32))
    ends = torch.cumsum(ext, dim=1, dtype=torch.int32)
    starts = (ends - ext).contiguous()
    outlen = ends[:, -1]
    ok = outlen <= N

    # covering token of output position p: the last token whose start is
    # <= p (starts are a cumsum, hence sorted per row)
    pos = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    cov = torch.searchsorted(starts, pos.contiguous(), right=True) - 1
    covc = cov.clamp(0, T - 1)
    tcov = torch.gather(tokens, 1, covc)
    covk = torch.where(cov < 0, 0, (tcov >> KIND_SHIFT) & 3)
    dist = ((tcov >> 8) & 0x7FFF) + 1
    par = torch.where(covk == 2, pos - dist, pos)
    ok &= ~((par < 0) & (pos < outlen[:, None])).any(dim=1)
    par = par.clamp(0, N - 1).to(torch.int64)
    lit = torch.where(covk == 1, tcov & 0xFF, 0)

    # pointer doubling to the root literal of every position's chain
    max_rounds = max(1, math.ceil(math.log2(max(N, 2)))) + 1
    for _ in range(max_rounds):
        par2 = torch.gather(par, 1, par)
        changed = bool((par2 != par).any())
        par = par2
        if not changed:
            break

    out = torch.gather(lit, 1, par).to(torch.uint8)
    return out, torch.clamp(outlen, max=N), ok
