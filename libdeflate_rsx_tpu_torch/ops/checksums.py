"""CRC-32 and Adler-32 on the device, in integer arithmetic.

Port of `libdeflate_rsx_tpu/ops/checksums.py`. The JAX package computes
the CRC's GF(2) products and the Adler sums as float matmuls, exact on
its matrix unit. Here every step is integer, so the result is exact
whatever the process's matmul precision (TF32, bf16).

`crc32_fixed`, `crc32_blocks`, `adler32_fixed` and `adler32_blocks` take
the CUDA kernels (`csrc/checksums.cu`) for CUDA tensors and their plain
versions, the `*_plain` functions below, for CPU tensors. The CRC-32
kernel runs one 1,024-thread block an SM, each thread over a 64-byte
span by slice-by-4 from tables a copy a lane, the spans folded by one
multiplication each with an operator from a table; one buffer as rows
of 64 KiB in the same launch, the block that finishes last ending it
(its three state words, zeroed once a stream and left zeroed by every
launch). The Adler-32 kernel runs a persistent grid over tiles of 64 KiB
of a row, each thread's 16-byte groups summed by dp4a, the block's parts
only added; a row of one tile ends in its block, a longer row's tiles
add their terms into the row's words by atomics and the last one ends
it; one buffer is one row in the same launch. Its words (three a wide
row, three for a buffer) are zeroed once a stream and left zeroed by
every launch. The plain versions, in plain PyTorch:

- **CRC-32.** The register is GF(2)-linear in the message, so the
  zero-init register of a CRC_CHUNK-byte chunk is the XOR over its bytes
  of a per-position table entry: one gather from a (CRC_CHUNK, 256)
  table built on the host from the shift-by-one-byte operator, then an
  XOR tree. Chunk registers fold in a log-depth tree of 32x32 bit-matrix
  applications (shift the left half past the right, XOR); the initial
  value and the zero padding are corrected with the shift operator and
  its inverse.
- **Adler-32.** Per-chunk byte sums and position-weighted sums, then a
  closed-form recombination mod 65521. int64 holds every partial sum, so
  the JAX package's int32-safe reductions are not needed.

uint32 values are held in int64.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .checksum_math import (
    ADLER_MOD,
    CRC_TABLE,
    SHIFT8,
    crc32_shift_operator,
    mat_apply,
)

CRC_CHUNK = 1024          # bytes per chunk register
ADLER_CHUNK = 128         # bytes per Adler partial sum
_MASK32 = 0xFFFFFFFF
_I64 = torch.int64

#: C calls made by the dispatchers on CUDA tensors (the plain versions do
#: not count)
LAUNCHES = 0
#: the kernels' state per (device, stream, kind): the CRC buffer route's
#: three int32 words; Adler's three int64 words a row wider than a tile, or
#: for a buffer; zeroed once, left zeroed by every launch, grown as needed
_STATE: dict[tuple[int, int, int], torch.Tensor] = {}


# -- host-built constants -----------------------------------------------------


@functools.lru_cache(maxsize=4)
def _crc_bitmatrix(chunk_len: int) -> np.ndarray:
    """(chunk_len, 8) uint32: entry [j, k] is the zero-init register's
    contribution of bit k of byte j (distance chunk_len-1-j from the
    chunk end)."""
    rows = np.zeros((chunk_len, 8), dtype=np.uint32)
    cur = np.array([CRC_TABLE[1 << k] for k in range(8)], dtype=np.uint32)
    for j in range(chunk_len - 1, -1, -1):
        rows[j] = cur
        if j > 0:
            cur = mat_apply(SHIFT8, cur)
    return rows


@functools.lru_cache(maxsize=4)
def _crc_byte_table(chunk_len: int) -> np.ndarray:
    """(chunk_len * 256,) int64: the contribution of byte value v at
    position j of a chunk, at index 256 * j + v (XOR of the bit rows of
    _crc_bitmatrix)."""
    rows = _crc_bitmatrix(chunk_len)
    v = np.arange(256, dtype=np.uint32)
    tab = np.zeros((chunk_len, 256), dtype=np.uint32)
    for k in range(8):
        tab ^= np.where(((v >> k) & 1).astype(bool)[None, :],
                        rows[:, k:k + 1], np.uint32(0))
    return tab.reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _shift_matrix_u32(nbytes: int) -> np.ndarray:
    """Shift-by-nbytes operator as 32 uint32 columns."""
    return crc32_shift_operator(nbytes).astype(np.uint32)


@functools.lru_cache(maxsize=64)
def _inverse_shift_u32(nbytes: int) -> np.ndarray:
    """Inverse of the shift-by-nbytes operator (Gauss-Jordan over GF(2)
    on the 32x32 bit matrix)."""
    m = crc32_shift_operator(nbytes)
    # [M | I], with M[r, c] = bit r of column c
    a = np.zeros((32, 64), dtype=np.uint8)
    for c in range(32):
        for r in range(32):
            a[r, c] = (int(m[c]) >> r) & 1
        a[c, 32 + c] = 1
    for col in range(32):
        piv = col + int(np.flatnonzero(a[col:, col])[0])
        a[[col, piv]] = a[[piv, col]]
        for r in range(32):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    inv = np.zeros(32, dtype=np.uint32)
    for c in range(32):
        for r in range(32):
            if a[r, 32 + c]:
                inv[c] |= np.uint32(1) << np.uint32(r)
    return inv


# -- integer GF(2) helpers ----------------------------------------------------


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR along the last dim, whose length is a power of two."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def _mat_apply(cols: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """Apply a 32x32 GF(2) bit matrix (32 uint32 columns) to the uint32
    values v (held in int64): the XOR of the columns of v's set bits."""
    c = torch.from_numpy(cols.astype(np.int64)).to(v.device)
    bits = (v[..., None] >> torch.arange(32, device=v.device)) & 1
    return _xor_reduce(torch.where(bits.bool(), c, 0))


def _chunk_registers(data: torch.Tensor) -> torch.Tensor:
    """Zero-init CRC registers of the CRC_CHUNK-byte chunks of data
    (..., n * CRC_CHUNK) uint8: (..., n) int64."""
    d = data.reshape(*data.shape[:-1], -1, CRC_CHUNK).to(_I64)
    tab = torch.from_numpy(_crc_byte_table(CRC_CHUNK)).to(data.device)
    idx = d + 256 * torch.arange(CRC_CHUNK, device=data.device)
    return _xor_reduce(tab[idx])


def _fold(regs: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Fold chunk registers (B, n) into one register per row by the
    shift-combine. Odd levels append the register of CRC_CHUNK << level
    zero bytes (zero), adding that many virtual bytes. Returns (register
    (B,), virtual length in bytes)."""
    span = CRC_CHUNK
    virtual_len = regs.shape[1] * CRC_CHUNK
    while regs.shape[1] > 1:
        if regs.shape[1] % 2:
            regs = torch.cat([regs, torch.zeros_like(regs[:, :1])], dim=1)
            virtual_len += span
        regs = _mat_apply(_shift_matrix_u32(span), regs[:, 0::2]) \
            ^ regs[:, 1::2]
        span *= 2
    return regs[:, 0], virtual_len


# -- CRC-32 -------------------------------------------------------------------


def crc32_fixed_plain(data: torch.Tensor, length: int, crc_in: int = 0):
    """CRC-32 of data[:length] continuing from crc_in. data (N,) uint8,
    zero-padded to a multiple of CRC_CHUNK. Returns a 0-dim int64
    tensor."""
    n = int(length)
    if n == 0:
        return torch.tensor(crc_in & _MASK32, dtype=_I64, device=data.device)
    if data.shape[0] % CRC_CHUNK or data.shape[0] < n:
        raise ValueError(f"data of {data.shape[0]} bytes is not {n} bytes "
                         f"padded to a multiple of {CRC_CHUNK}")
    reg, virtual_len = _fold(_chunk_registers(data)[None])
    # register of (M || 0^p) from init: S^{virtual_len}(init) ^ A(M || 0^p)
    init = torch.tensor([(crc_in & _MASK32) ^ _MASK32], dtype=_I64,
                        device=data.device)
    reg = reg ^ _mat_apply(_shift_matrix_u32(virtual_len), init)
    if virtual_len > n:
        reg = _mat_apply(_inverse_shift_u32(virtual_len - n), reg)
    return reg[0] ^ _MASK32


def crc32_blocks_plain(data: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32 of each row's first lengths[b] bytes. data (B, S) uint8
    with S a multiple of CRC_CHUNK, rows zero-padded; lengths (B,).
    The padding is undone by applying the inverse shift for each set bit
    of the row's padding length. Returns (B,) int64."""
    b, s = data.shape
    if s % CRC_CHUNK:
        raise ValueError(f"row width {s} is not a multiple of {CRC_CHUNK}")
    reg, virtual_len = _fold(_chunk_registers(data))
    init = torch.full((b,), _MASK32, dtype=_I64, device=data.device)
    reg = reg ^ _mat_apply(_shift_matrix_u32(virtual_len), init)
    pad = virtual_len - lengths.to(_I64)
    for t in range(max(1, virtual_len.bit_length())):
        stepped = _mat_apply(_inverse_shift_u32(1 << t), reg)
        reg = torch.where(((pad >> t) & 1).bool(), stepped, reg)
    return reg ^ _MASK32


# -- Adler-32 -----------------------------------------------------------------


def _adler_sums(data: torch.Tensor):
    """Per-chunk (byte sum, sum of j * byte) over ADLER_CHUNK-byte
    chunks of data (..., c * ADLER_CHUNK) uint8, each (..., c) int64."""
    d = data.reshape(*data.shape[:-1], -1, ADLER_CHUNK).to(_I64)
    j = torch.arange(ADLER_CHUNK, device=data.device)
    return d.sum(-1), (d * j).sum(-1)


def _adler_combine(s1_c, j_c, n, s1_in, s2_in):
    """Adler-32 from per-chunk sums of a message of n bytes (per row):
    s1 = s1_in + sum(d), s2 = s2_in + n * s1_in + sum((n - i) d_i),
    where sum((n - i) d_i) = sum_c ((n - c * ADLER_CHUNK) S1_c - J_c)."""
    c = s1_c.shape[-1]
    off = torch.arange(c, device=s1_c.device) * ADLER_CHUNK
    coef = (n[..., None] - off) % ADLER_MOD
    weighted = ((coef * (s1_c % ADLER_MOD)) % ADLER_MOD).sum(-1) \
        - (j_c % ADLER_MOD).sum(-1)
    s1 = (s1_in + s1_c.sum(-1)) % ADLER_MOD
    s2 = (s2_in + (n % ADLER_MOD) * s1_in + weighted) % ADLER_MOD
    return (s2 << 16) | s1


def adler32_fixed_plain(data: torch.Tensor, length: int,
                        adler_in: int = 1):
    """Adler-32 of data[:length] continuing from adler_in. data (N,)
    uint8, zero-padded to a multiple of ADLER_CHUNK. Returns a 0-dim
    int64 tensor."""
    n = int(length)
    adler_in &= _MASK32
    if n == 0:
        return torch.tensor(adler_in, dtype=_I64, device=data.device)
    if data.shape[0] % ADLER_CHUNK or data.shape[0] < n:
        raise ValueError(f"data of {data.shape[0]} bytes is not {n} bytes "
                         f"padded to a multiple of {ADLER_CHUNK}")
    s1_c, j_c = _adler_sums(data)
    nt = torch.tensor(n, dtype=_I64, device=data.device)
    return _adler_combine(s1_c, j_c, nt, adler_in & 0xFFFF, adler_in >> 16)


def adler32_blocks_plain(data: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Adler-32 of each row's first lengths[b] bytes (rows zero-padded:
    zero bytes add nothing to s1, and the weights use the true length).
    data (B, S) uint8 with S a multiple of ADLER_CHUNK. Returns (B,)
    int64."""
    if data.shape[1] % ADLER_CHUNK:
        raise ValueError(f"row width {data.shape[1]} is not a multiple of "
                         f"{ADLER_CHUNK}")
    s1_c, j_c = _adler_sums(data)
    return _adler_combine(s1_c, j_c, lengths.to(_I64), 1, 0)


# -- the CUDA kernel and the dispatchers --------------------------------------

_CRC, _ADLER = 0, 1
_TILE = 65536             # bytes a tile of a row in the kernel


def _kernel(name: str):
    return _bind(_build.load("checksums"), name)


def _bind(lib, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        if name == "ldrsx_checksum_rows":
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64] \
                + [ctypes.c_void_p] * 4
        else:
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_uint32] + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return fn


def _check_bytes(data: torch.Tensor, ndim: int, name: str) -> None:
    if data.dtype != torch.uint8 or data.dim() != ndim:
        raise ValueError(f"{name}: data must be a {ndim}-D uint8 tensor, "
                         f"not {data.dim()}-D {data.dtype}")


def _launch(name: str, *args, device, stream) -> None:
    global LAUNCHES
    with torch.cuda.device(device):
        rc = _kernel(name)(*args, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"checksums kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


def _state(stream, kind: int, words: int) -> torch.Tensor:
    """The zeroed state of kind's launches on stream, at least `words`
    long (int32 for the CRC, int64 for Adler): a larger one replaces it
    zeroed, and every launch leaves it zeroed."""
    key = (stream.device.index, stream.cuda_stream, kind)
    st = _STATE.get(key)
    if st is None or st.numel() < words:
        st = _STATE[key] = torch.zeros(
            words, dtype=torch.int32 if kind == _CRC else _I64,
            device=stream.device)
    return st


def _buffer(kind: int, data: torch.Tensor, n: int, init: int):
    """The kernel over data[:n] (1-D uint8 on the card, n > 0),
    continuing from `init`, in one launch with its stream's state: a
    0-dim int64 tensor."""
    data = data.contiguous()
    stream = torch.cuda.current_stream(data.device)
    scratch = _state(stream, kind, 4 if kind == _CRC else 3)
    out = torch.empty((), dtype=_I64, device=data.device)
    _launch("ldrsx_checksum_buffer", kind, data.data_ptr(), n,
            init & _MASK32, scratch.data_ptr(), out.data_ptr(),
            device=data.device, stream=stream)
    return out


def _rows(kind: int, data: torch.Tensor, lengths: torch.Tensor, chunk: int,
          name: str) -> torch.Tensor:
    """The kernel over the rows of data (B, S) uint8 on the card, each
    cut at its length: (B,) int64. A row view whose bytes are not
    adjacent is copied; rows at any stride are read in place. Adler rows
    wider than a tile take three words a row of the stream's state."""
    _check_bytes(data, 2, name)
    b, s = data.shape
    if s % chunk:
        raise ValueError(f"row width {s} is not a multiple of {chunk}")
    if lengths.shape != (b,) or lengths.device != data.device:
        raise ValueError(f"{name}: lengths of shape {tuple(lengths.shape)} "
                         f"on {lengths.device}; want ({b},) on "
                         f"{data.device}")
    if data.stride(1) != 1:
        data = data.contiguous()
    n = lengths.to(_I64).contiguous()
    out = torch.empty(b, dtype=_I64, device=data.device)
    if b:
        stream = torch.cuda.current_stream(data.device)
        scratch = _state(stream, kind, 3 * b).data_ptr() \
            if kind == _ADLER and s > _TILE else None
        _launch("ldrsx_checksum_rows", kind, data.data_ptr(), data.stride(0),
                b, s, n.data_ptr(), scratch, out.data_ptr(),
                device=data.device, stream=stream)
    return out


def crc32_fixed(data: torch.Tensor, length: int, crc_in: int = 0):
    """CRC-32 of data[:length] continuing from crc_in. data (N,) uint8,
    zero-padded to a multiple of CRC_CHUNK. Returns a 0-dim int64
    tensor. CUDA tensors take the kernel, CPU tensors
    `crc32_fixed_plain`."""
    if data.device.type == "cpu":
        return crc32_fixed_plain(data, length, crc_in)
    _check_bytes(data, 1, "crc32_fixed")
    n = int(length)
    if n == 0:
        return torch.tensor(crc_in & _MASK32, dtype=_I64, device=data.device)
    if data.shape[0] % CRC_CHUNK or data.shape[0] < n:
        raise ValueError(f"data of {data.shape[0]} bytes is not {n} bytes "
                         f"padded to a multiple of {CRC_CHUNK}")
    return _buffer(_CRC, data, n, crc_in)


def crc32_blocks(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32 of each row's first lengths[b] bytes. data (B, S) uint8
    with S a multiple of CRC_CHUNK, rows zero-padded; lengths (B,) of
    any integer type. Returns (B,) int64. CUDA tensors take the kernel,
    CPU tensors `crc32_blocks_plain`."""
    if data.device.type == "cpu":
        return crc32_blocks_plain(data, lengths)
    return _rows(_CRC, data, lengths, CRC_CHUNK, "crc32_blocks")


def adler32_fixed(data: torch.Tensor, length: int, adler_in: int = 1):
    """Adler-32 of data[:length] continuing from adler_in. data (N,)
    uint8, zero-padded to a multiple of ADLER_CHUNK. Returns a 0-dim
    int64 tensor. CUDA tensors take the kernel, CPU tensors
    `adler32_fixed_plain`."""
    if data.device.type == "cpu":
        return adler32_fixed_plain(data, length, adler_in)
    _check_bytes(data, 1, "adler32_fixed")
    n = int(length)
    adler_in &= _MASK32
    if n == 0:
        return torch.tensor(adler_in, dtype=_I64, device=data.device)
    if data.shape[0] % ADLER_CHUNK or data.shape[0] < n:
        raise ValueError(f"data of {data.shape[0]} bytes is not {n} bytes "
                         f"padded to a multiple of {ADLER_CHUNK}")
    return _buffer(_ADLER, data, n, adler_in)


def adler32_blocks(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Adler-32 of each row's first lengths[b] bytes (rows zero-padded).
    data (B, S) uint8 with S a multiple of ADLER_CHUNK; lengths (B,) of
    any integer type. Returns (B,) int64. CUDA tensors take the kernel,
    CPU tensors `adler32_blocks_plain`."""
    if data.device.type == "cpu":
        return adler32_blocks_plain(data, lengths)
    return _rows(_ADLER, data, lengths, ADLER_CHUNK, "adler32_blocks")


# -- one call over a byte string ----------------------------------------------


def _padded(data: bytes, multiple: int, device) -> torch.Tensor:
    arr = np.zeros(-(-len(data) // multiple) * multiple, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(arr).to(device)


def crc32_device(data: bytes, crc: int = 0, device="cuda") -> int:
    """CRC-32 of a byte string on the device, continuing from crc."""
    if not data:
        return crc
    return int(crc32_fixed(_padded(data, CRC_CHUNK, device), len(data), crc))


def adler32_device(data: bytes, adler: int = 1, device="cuda") -> int:
    """Adler-32 of a byte string on the device, continuing from adler."""
    if not data:
        return adler
    return int(adler32_fixed(_padded(data, ADLER_CHUNK, device), len(data),
                             adler))
