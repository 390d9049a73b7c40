"""Pass 2 of the two-pass decoder: LZ copy resolution.

Port of `libdeflate_rsx_tpu/ops/resolve.py::resolve_batch_jax` (whose
host counterpart is the JAX package's `native/codec.c`
`resolve_tokens_c`). `resolve_batch` launches the CUDA kernel
`csrc/resolve.cu` for CUDA tensors and runs `resolve_batch_plain` for
CPU tensors. The kernel's call scans each stream's token extents in one
pass (a chained scan with a decoupled look-back), resolves every 8 KiB
window of output of every stream at once (a covering map and pointer
jumping in shared memory; a source before the window becomes a marker),
then walks each stream's windows in order and reads the markers' bytes
from a ring of the bytes before them (the source notes the design and
its bound).

`resolve_batch_plain` is plain PyTorch on either device: every output
position finds the token that covers it (a binary search in the token
start offsets), points at its source (`p - dist` inside a match, itself
at a literal), and pointer doubling walks every position to its root
literal in ceil(log2(chain depth)) gather rounds. A final gather reads
the bytes.

`resolve_tokens_device` is the list form of the JAX package's function
of that name: token columns in, one `bytes` or None per stream out.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .tokens import KIND_SHIFT

__all__ = ["resolve_batch", "resolve_batch_plain", "resolve_tokens_device"]

#: kernel launches made by `resolve_batch` (the plain version does not
#: count)
LAUNCHES = 0


def _lib():
    lib = _build.load("resolve")
    if lib.ldrsx_resolve.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ldrsx_resolve_scratch.argtypes = [i, i, q]
        lib.ldrsx_resolve_scratch.restype = ctypes.c_int64
        lib.ldrsx_resolve.argtypes = [p, q, i, p, i, q, p, p, q, p, p, p]
        lib.ldrsx_resolve.restype = ctypes.c_int
    return lib


def resolve_batch(tokens: torch.Tensor, out_cap: int,
                  counts: torch.Tensor | None = None):
    """tokens (B, T) int32 -> (bytes (B, out_cap) uint8, outlen (B,) int32,
    ok (B,) bool), on the tokens' device.

    `ok` is False when a stream's tokens write past out_cap or a match
    reaches before the start of its output. Bytes at or past a stream's
    outlen, and every byte of a row that is not ok, are unspecified;
    callers slice to outlen. NOP tokens (kind 0) and kind 3 may appear
    anywhere and emit nothing. `counts` (B,) int32, optional (pass 1's
    per-stream token counts, `stats[:, 3]`): the tokens of row b at or
    past counts[b] are not read and emit nothing. A CUDA tensor launches
    the kernel, with no host sync; the columns may be a strided view
    (row stride only).
    """
    global LAUNCHES
    if tokens.dim() != 2 or out_cap < 0:
        raise ValueError("resolve_batch: tokens must be (B, T), out_cap >= 0")
    if counts is not None and counts.shape != tokens.shape[:1]:
        raise ValueError("resolve_batch: counts must be (B,)")
    if tokens.device.type == "cpu":
        return resolve_batch_plain(tokens, out_cap, counts)
    tokens = tokens.to(torch.int32)
    b, t = tokens.shape
    if t > 1 and tokens.stride(1) != 1:
        tokens = tokens.contiguous()
    dev = tokens.device
    if counts is not None:
        counts = counts.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, out_cap), dtype=torch.uint8, device=dev)
    outlen = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    if b == 0:
        return out, outlen, ok
    lib = _lib()
    scratch = torch.empty(lib.ldrsx_resolve_scratch(b, t, out_cap),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ldrsx_resolve(tokens.data_ptr(), tokens.stride(0), t,
                               None if counts is None else counts.data_ptr(),
                               b, out_cap, scratch.data_ptr(), out.data_ptr(),
                               out_cap, outlen.data_ptr(), ok.data_ptr(),
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"resolve kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out, outlen, ok


def resolve_batch_plain(tokens: torch.Tensor, out_cap: int,
                        counts: torch.Tensor | None = None):
    """Plain version of the kernel, on any device: `resolve_batch`'s
    function by a binary-search covering map and pointer doubling
    (module docstring)."""
    tokens = tokens.to(torch.int32)
    if counts is not None:
        idx = torch.arange(tokens.shape[1], device=tokens.device)
        keep = idx < counts.to(tokens.device).reshape(-1, 1)
        tokens = torch.where(keep, tokens, 0)
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


def resolve_tokens_device(token_cols, out_cap: int,
                          device=None) -> list[bytes | None]:
    """Resolve a batch of pass-1 token columns on `device` (default:
    cuda; "cpu" runs the plain version).

    token_cols: (B, T) int32, a numpy array or a tensor: one stream per
    row, tokens step-major, NOPs anywhere. Row i gives
    `out[i, :min(outlen[i], out_cap)]` as bytes when it is ok, else None.
    On a card the resolve kernel runs once, and out, outlen and ok come
    to the host in one copy each. T == 0 gives empty bytes for every row
    (the JAX function raises an IndexError there)."""
    device = torch.device(device or "cuda")
    toks = torch.as_tensor(token_cols, dtype=torch.int32).to(device)
    out, outlen, ok = resolve_batch(toks, out_cap)
    out_h, len_h, ok_h = out.cpu().numpy(), outlen.tolist(), ok.tolist()
    return [out_h[i, :len_h[i]].tobytes() if ok_h[i] else None
            for i in range(len(ok_h))]
