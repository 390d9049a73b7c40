"""The device checksums: the port's integer CRC-32 and Adler-32 against
zlib and against the JAX package's functions, on the CPU, at the sizes,
initial values, odd chunk counts and empty input of
tests/test_device_checksums.py; the dispatchers on CPU tensors against
the plain versions; and numpy models of the CUDA kernels'
decompositions (csrc/checksums.cu) against zlib and the plain versions
on the trap rows and buffers of tests/_port_corpus.py:
- CRC-32: 64-byte spans by slice-by-4 from tables a copy a lane, 1,024
  spans a tile; each whole span's register moved to the end of the
  row's last whole span by one multiplication with an operator from a
  table (x^(512 d)), XORed in half warps and then across them, the
  tail shift x^(8 r) and the partial span's register added once; a row
  wider than a tile carrying its register from tile to tile; one buffer
  as rows of a tile (64 KiB), each but the last moved by
  x^(8 65,536 m) (two table entries) and XORed, the last row's
  register and its shift applied at the end with the initial value's
  term; the multiplication by 16 integer products of masked operands
  and the tables' shift by 4 zero bytes;
- Adler-32: 256 threads a row, each over a contiguous span with the
  running sums and their mod steps, the spans folded in shuffle order,
  one buffer as rows of 64 KiB folded by a 256-thread block.
Tolerance: exact equality."""

import os
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import (CHECKSUM_BUFFER_ROW, CHECKSUM_INITS,
                          CHECKSUM_SPAN, CHECKSUM_THREADS, CHECKSUM_TILE,
                          CHECKSUM_WIDE, CHECKSUM_WIDTHS, checksum_buffers,
                          checksum_lengths, checksum_rows,
                          checksum_wide_rows)
from libdeflate_rsx_tpu.ops import checksums as jck
from libdeflate_rsx_tpu_torch.ops import adler32_device, crc32_device
from libdeflate_rsx_tpu_torch.ops import checksums as pck
from libdeflate_rsx_tpu_torch.ops.checksum_math import CRC_TABLE
from tests.conftest import make_corpus

torch.set_num_threads(2)
SIZES = [1, 2, 127, 128, 129, 1023, 1024, 1025, 4096, 5000, 65536, 100001,
         1 << 20]


@pytest.mark.parametrize("size", SIZES)
def test_crc32_device(size):
    data = make_corpus("random", size)
    got = crc32_device(data, device="cpu")
    assert got == zlib.crc32(data) == jck.crc32_device(data)


@pytest.mark.parametrize("size", SIZES)
def test_adler32_device(size):
    data = make_corpus("random", size)
    got = adler32_device(data, device="cpu")
    assert got == zlib.adler32(data) == jck.adler32_device(data)


def test_device_checksums_init_value():
    a = make_corpus("text", 3000)
    b = make_corpus("text", 5000, seed=9)
    crc, adler = zlib.crc32(a), zlib.adler32(a)
    assert crc32_device(b, crc=crc, device="cpu") == zlib.crc32(a + b) \
        == jck.crc32_device(b, crc=crc)
    assert adler32_device(b, adler=adler, device="cpu") \
        == zlib.adler32(a + b) == jck.adler32_device(b, adler=adler)


@pytest.mark.parametrize("chunks", [3, 5, 7, 9])
def test_device_checksums_odd_chunk_counts(chunks):
    """Odd chunk counts take the fold's zero-register path."""
    data = make_corpus("random", 1024 * chunks, seed=chunks)
    assert crc32_device(data, device="cpu") == zlib.crc32(data)
    assert adler32_device(data, device="cpu") == zlib.adler32(data)


def test_empty():
    assert crc32_device(b"", device="cpu") == 0
    assert adler32_device(b"", device="cpu") == 1
    assert crc32_device(b"", crc=123, device="cpu") == 123
    assert int(pck.crc32_fixed_plain(torch.zeros(1024, dtype=torch.uint8),
                                     0, 77)) == 77
    assert int(pck.adler32_fixed_plain(torch.zeros(128, dtype=torch.uint8),
                                       0, 99)) == 99


@pytest.mark.parametrize("length", [1, 1000, 3071, 3072])
def test_fixed_equals_jax_on_padded_rows(length):
    """crc32_fixed and adler32_fixed on one zero-padded row of 3 KiB,
    with an initial value, equal the JAX functions."""
    row = np.zeros(3072, np.uint8)
    row[:length] = np.frombuffer(make_corpus("text", length, seed=length),
                                 np.uint8)
    t, j = torch.from_numpy(row), jnp.asarray(row)
    assert int(pck.crc32_fixed_plain(t, length, 0xDEADBEEF)) == \
        int(jck.crc32_fixed(j, length, 0xDEADBEEF)) == \
        zlib.crc32(row[:length].tobytes(), 0xDEADBEEF)
    assert int(pck.adler32_fixed_plain(t, length, 0x12345678 % 65521)) == \
        int(jck.adler32_fixed(j, length, 0x12345678 % 65521))


@pytest.mark.parametrize("width", [4096, 5120])
def test_blocks_checksums_traced_lengths(width):
    """Per-row lengths inside one batch, against zlib and the JAX
    functions (5 chunks per row at width 5120: an odd fold)."""
    lengths = np.array([0, 1, 1000, width - 1, width], np.int32)
    rng = np.random.default_rng(7)
    data = np.zeros((len(lengths), width), np.uint8)
    for i, ln in enumerate(lengths):
        data[i, :ln] = rng.integers(0, 256, ln)
    args = torch.from_numpy(data), torch.from_numpy(lengths)
    crcs = pck.crc32_blocks_plain(*args).numpy()
    adlers = pck.adler32_blocks_plain(*args).numpy()
    jargs = jnp.asarray(data), jnp.asarray(lengths)
    assert np.array_equal(crcs, np.asarray(jck.crc32_blocks(*jargs)))
    assert np.array_equal(adlers, np.asarray(jck.adler32_blocks(*jargs)))
    for i, ln in enumerate(lengths):
        raw = data[i, :ln].tobytes()
        assert int(crcs[i]) == zlib.crc32(raw), (i, ln)
        assert int(adlers[i]) == zlib.adler32(raw), (i, ln)


def test_inverse_shift_undoes_the_shift():
    from libdeflate_rsx_tpu_torch.ops.checksum_math import mat_apply

    v = np.array([1, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    for n in (1, 7, 1024, 65536 + 3):
        fwd = mat_apply(pck._shift_matrix_u32(n), v)
        assert np.array_equal(mat_apply(pck._inverse_shift_u32(n), fwd), v)
        assert np.array_equal(pck._inverse_shift_u32(n),
                              jck._inverse_shift_u32(n))


# -- numpy models of the CUDA kernels' decompositions ------------------------

POLY = 0xEDB88320
MOD = 65521
ONE = np.uint32(0x80000000)     # x^0, reflected
F32 = np.uint32(0xFFFFFFFF)
FOLD_THREADS = 256          # threads of the Adler one-block fold
ADLER_GROUPS = 256          # 16-byte groups between the Adler mod steps
BATCH = 8                   # 16-byte loads an Adler thread issues together
CRC_THREADS = 1024          # threads a CRC block: spans a tile
HALF = 16                   # a row's CRC threads come in these
KERNEL = os.path.join(os.path.dirname(pck.__file__), os.pardir, "csrc",
                      "checksums.cu")


def multmodp(a, b):
    """a * b mod P, reflected (bit 31 is x^0), elementwise."""
    a, b = np.broadcast_arrays(np.asarray(a, np.uint32),
                               np.asarray(b, np.uint32))
    p, b = np.zeros(b.shape, np.uint32), b.copy()
    for i in range(32):
        p ^= np.where((a >> np.uint32(31 - i)) & 1, b, np.uint32(0))
        b = (b >> np.uint32(1)) ^ np.where(b & 1, np.uint32(POLY),
                                           np.uint32(0))
    return p


def _x2n():
    t = [np.uint32(1 << 30)]
    for _ in range(31):
        t.append(multmodp(t[-1], t[-1])[()])
    return np.array(t, np.uint32)


X2N = _x2n()


def x8nmodp(n):
    """x^(8 n) mod P, elementwise over int64 n: zlib's x2nmodp(n, 3)."""
    n = np.array(n, np.int64)
    p = np.full(n.shape, ONE, np.uint32)
    k = 3
    while (n > 0).any():
        take = (n & 1).astype(bool)
        if take.any():
            p = np.where(take, multmodp(X2N[k & 31], p), p)
        n >>= 1
        k += 1
    return p


def _slice_tables():
    """Table k, entry v: the zero-init register of byte v and then k
    zero bytes (slice-by-4 takes tables 0-3)."""
    t = np.zeros((4, 256), np.uint32)
    for v in range(256):
        r = v
        for _ in range(8):
            r = (r >> 1) ^ (POLY if r & 1 else 0)
        t[0, v] = r
    for k in range(1, 4):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0, t[k - 1] & 0xFF]
    return t


TABLES = _slice_tables()


def _chain(step, n):
    """ONE, step, step^2, ... (n entries), by multiplication in turn."""
    out = [ONE]
    for _ in range(n - 1):
        out.append(multmodp(out[-1], step)[()])
    return np.array(out, np.uint32)


LOG_SPAN = (8 * CHECKSUM_SPAN).bit_length() - 1     # x^(8 SPAN) = X2N[.]
LOG_TILE = (8 * CHECKSUM_TILE).bit_length() - 1
# the kernel's operator tables (Ops, computed there at compile time)
TAIL = _chain(X2N[3], CHECKSUM_SPAN)                  # x^(8 r)
SPAN_OPS = _chain(multmodp(TAIL[-1], X2N[3])[()],
                  CHECKSUM_TILE // CHECKSUM_SPAN + 1)  # x^(8 SPAN d)
ROW_LO = _chain(SPAN_OPS[-1], 256)                    # x^(8 TILE m)
ROW_HI = _chain(multmodp(ROW_LO[-1], SPAN_OPS[-1])[()], 256)


def row_shift(m):
    """x^(8 TILE m), elementwise over int64 m: two table entries, then
    X2N[log2(8 TILE) + 16 + b] for each bit b of m >> 16."""
    m = np.asarray(m, np.int64)
    p = multmodp(ROW_LO[m & 255], ROW_HI[(m >> 8) & 255])
    hi, k = m >> 16, LOG_TILE + 16
    while (hi > 0).any():
        p = np.where(hi & 1, multmodp(X2N[k & 31], p), p)
        hi >>= 1
        k += 1
    return p


def crc_layout(width):
    """(threads a row in a step, rows a step) of the CRC kernel."""
    spans = -(-min(width, CHECKSUM_TILE) // CHECKSUM_SPAN)
    tp = max(HALF, -(-spans // HALF) * HALF)
    return tp, 1 if width > CHECKSUM_TILE else CRC_THREADS // tp


def crc_spans(spans, n, c0):
    """Each span's register: spans (M, SPAN) uint8, zero past n (M,),
    from c0 (M,): slice-by-4 on the 4-byte words inside n, then the
    last n % 4 bytes one at a time (rows start aligned)."""
    w = np.ascontiguousarray(spans).view("<u4")
    c = np.asarray(c0, np.uint32).copy()
    t = TABLES
    for k in range(CHECKSUM_SPAN // 4):
        x = c ^ w[:, k]
        step = (t[3, x & 0xFF] ^ t[2, (x >> 8) & 0xFF]
                ^ t[1, (x >> 16) & 0xFF] ^ t[0, x >> 24])
        c = np.where(4 * k + 4 <= n, step, c)
    nb = n // 4 * 4
    at = np.arange(len(c))
    for i in range(3):
        b = spans[at, np.minimum(nb + i, CHECKSUM_SPAN - 1)]
        c = np.where(nb + i < n, t[0, (c ^ b) & 0xFF] ^ (c >> np.uint32(8)),
                     c)
    return c


def crc_tile(tile, lc, init, carry=None):
    """A step over one tile of each row: tile (R, tp * SPAN) uint8 zero
    past lc (R,), the tile's bytes of the row; init: span 0 starts from
    0xFFFFFFFF; carry (R,): the row's register before the tile, added
    by thread 0 moved past the tile's whole spans. Each whole span j of
    J is moved by SPAN_OPS[J - 1 - j], the registers XORed in half warps
    and then across them, the tail shift TAIL[r] applied and the partial
    span's register added: the register at the tile's end (R,)."""
    r_n = tile.shape[0]
    tp = tile.shape[1] // CHECKSUM_SPAN
    j = np.arange(tp)
    lc = np.asarray(lc, np.int64)
    n = np.clip(lc[:, None] - CHECKSUM_SPAN * j, 0, CHECKSUM_SPAN)
    c0 = np.where((j == 0) & init, F32, np.uint32(0))
    c0 = np.broadcast_to(c0, n.shape).ravel()
    regs = crc_spans(tile.reshape(r_n * tp, CHECKSUM_SPAN), n.ravel(),
                     c0).reshape(r_n, tp)
    whole = lc // CHECKSUM_SPAN
    d = np.clip(whole[:, None] - 1 - j, 0, len(SPAN_OPS) - 1)
    v = np.where(n == CHECKSUM_SPAN, multmodp(regs, SPAN_OPS[d]),
                 np.uint32(0))
    if carry is not None:
        v[:, 0] ^= multmodp(carry, SPAN_OPS[whole])
    halves = np.bitwise_xor.reduce(v.reshape(r_n, tp // HALF, HALF), axis=2)
    acc = np.bitwise_xor.reduce(halves, axis=1)
    r = lc % CHECKSUM_SPAN
    part = regs[np.arange(r_n), np.minimum(whole, tp - 1)]
    return np.where(r > 0, multmodp(acc, TAIL[r]) ^ part, acc)


def model_crc_rows(rows, lens):
    """The CRC kernel on rows (R, s) uint8 cut at lens: each row's CRC-32
    (int64 (R,)); a row wider than a tile takes its tiles in order,
    carrying its register."""
    r_n, s = rows.shape
    lens = np.clip(np.asarray(lens, np.int64), 0, s)
    tp, _ = crc_layout(s)
    tiles = max(1, -(-s // CHECKSUM_TILE))
    wide = tp * CHECKSUM_SPAN * tiles
    if wide != s:
        rows = np.pad(rows, ((0, 0), (0, wide - s)))
    out = np.zeros(r_n, np.uint32)
    carry = np.zeros(r_n, np.uint32)
    for c in range(tiles):
        cut = slice(c * tp * CHECKSUM_SPAN, (c + 1) * tp * CHECKSUM_SPAN)
        lc = np.clip(lens - c * CHECKSUM_TILE, 0, CHECKSUM_TILE)
        acc = crc_tile(rows[:, cut], lc, c == 0, carry if c else None)
        here = (c == 0) | (c * CHECKSUM_TILE < lens)
        more = (c + 1) * CHECKSUM_TILE < lens
        carry = np.where(here & more, acc, carry)
        out = np.where(here & ~more, np.where(lens > 0, acc ^ F32, 0), out)
    return out.astype(np.int64)


def model_crc_buffer_end(regs, total, init):
    """The buffer route's end from its rows' registers (each at its
    row's end, the last row short): every row but the last moved to the
    end of the next-to-last by row_shift and XORed, as the blocks'
    atomicXor; the block that finishes last moves the sum past the last
    row (SPAN_OPS and TAIL), adds the last row's register, the initial
    value's term x^(8 total) (init ^ 0xFFFFFFFF) and the final XOR."""
    regs = np.asarray(regs, np.uint32)
    r_n = len(regs)
    moved = multmodp(regs[:-1], row_shift(r_n - 2 - np.arange(r_n - 1)))
    acc = np.bitwise_xor.reduce(moved) if r_n > 1 else np.uint32(0)
    n_last = total - (r_n - 1) * CHECKSUM_TILE
    acc = multmodp(acc, SPAN_OPS[n_last // CHECKSUM_SPAN])
    if n_last % CHECKSUM_SPAN:
        acc = multmodp(acc, TAIL[n_last % CHECKSUM_SPAN])
    term = multmodp(x8nmodp(total), np.uint32((init ^ 0xFFFFFFFF)
                                              & 0xFFFFFFFF))
    return int(term ^ acc ^ regs[-1] ^ F32)


def model_crc_buffer(data: bytes, init: int) -> int:
    """The one-buffer route: rows of 64 KiB (the last one short), each
    row's register from zero at its end, then model_crc_buffer_end."""
    n, row = len(data), CHECKSUM_BUFFER_ROW
    if n == 0:
        return init & 0xFFFFFFFF
    rows = np.zeros((-(-n // row), row), np.uint8)
    rows.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.minimum(n - np.arange(len(rows)) * row, row)
    return model_crc_buffer_end(crc_tile(rows, lens, False), n, init)


def adler_span_parts(rows, lens):
    """Each Adler thread's (s1, s2, len) over rows (R, s) uint8 cut at
    lens (R,): head bytes to a 16-byte boundary (rows start aligned),
    batches of BATCH 16-byte groups, single groups, tail bytes; the sums
    reduced once ADLER_GROUPS groups are in, checked to stay below
    2^32."""
    r_n, s = rows.shape
    span = -(-s // CHECKSUM_THREADS)
    b0 = np.arange(CHECKSUM_THREADS, dtype=np.int64) * span
    ln = np.asarray(lens, np.int64)[:, None]
    begin, end = np.minimum(b0, ln), np.minimum(b0 + span, ln)
    i = begin.copy()
    rr = np.arange(r_n)[:, None]
    s1 = np.zeros(begin.shape, np.int64)
    s2 = np.zeros(begin.shape, np.int64)
    groups = np.zeros(begin.shape, np.int64)

    def byte_step(m):
        nonlocal s1, s2
        d = rows[rr, np.minimum(i, s - 1)].astype(np.int64)
        s1 = np.where(m, s1 + d, s1)
        s2 = np.where(m, s2 + s1, s2)

    def groups_step(m, count):
        nonlocal s1, s2, i
        for _ in range(count):
            d = rows[rr[..., None], np.minimum(i[..., None] + np.arange(16),
                                               s - 1)]
            for k in range(16):
                s1 = np.where(m, s1 + d[..., k], s1)
                s2 = np.where(m, s2 + s1, s2)
            assert s2.max(initial=0) < 1 << 32
            i += 16 * m
        groups[:] += count * m
        wrap = groups >= ADLER_GROUPS
        s1, s2 = np.where(wrap, s1 % MOD, s1), np.where(wrap, s2 % MOD, s2)
        groups[wrap] = 0

    while ((m := (i < end) & (i % 16 != 0))).any():
        byte_step(m)
        i += m
    while ((m := i + 16 * BATCH <= end)).any():
        groups_step(m, BATCH)
    while ((m := i + 16 <= end)).any():
        groups_step(m, 1)
    while ((m := i < end)).any():
        byte_step(m)
        i += m
    assert s2.max(initial=0) < 1 << 32
    return s1 % MOD, s2 % MOD, np.maximum(end - begin, 0)


def adler_combine(x, y):
    """The Adler fold step on (s1, s2, len) parts, mod 65,521."""
    (xa, xb, xl), (ya, yb, yl) = x, y
    return (xa + ya) % MOD, (xb + yb + (yl % MOD) * xa) % MOD, xl + yl


def warp_fold(parts):
    """__shfl_down_sync order over the last axis (32 lanes): lane 0's
    result."""
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        src = np.where(lane + off < 32, lane + off, lane)
        q = tuple(x[..., src] for x in parts)
        c = adler_combine(parts, q)
        take = (lane % (2 * off)) == 0
        parts = tuple(np.where(take, cc, x) for cc, x in zip(c, parts))
    return tuple(x[..., 0] for x in parts)


def block_fold(parts):
    """The block's fold over the last axis (its threads): each warp,
    then warp 0 over the warps' results, lanes past them empty."""
    t = parts[0].shape[-1]
    w = tuple(x.reshape(*x.shape[:-1], t // 32, 32) for x in parts)
    w = warp_fold(w)
    pad = [(0, 0)] * (w[0].ndim - 1) + [(0, 32 - t // 32)]
    return warp_fold(tuple(np.pad(x, pad) for x in w))


def model_adler_rows(rows, lens, raw=False):
    """The Adler row kernel: each row's Adler-32, or with raw its
    (s2 << 16 | s1) from zero; int64 (R,)."""
    lens = np.clip(np.asarray(lens, np.int64), 0, rows.shape[1])
    a, b, _ = block_fold(adler_span_parts(rows, lens))
    if raw:
        return b << 16 | a
    return ((b + lens % MOD) % MOD) << 16 | (1 + a) % MOD


def model_adler_fold(regs, total, init):
    """The Adler one-block fold of one buffer's raw row sums (rows of
    CHECKSUM_BUFFER_ROW bytes, the last one short), then the initial
    value."""
    regs = np.asarray(regs, np.int64)
    r_n, row = len(regs), CHECKSUM_BUFFER_ROW
    per = -(-r_n // FOLD_THREADS)
    r0 = np.arange(FOLD_THREADS) * per
    r1 = np.minimum(r0 + per, r_n)
    acc = tuple(np.zeros(FOLD_THREADS, np.int64) for _ in range(3))
    for j in range(per):
        r = r0 + j
        ok = r < r1
        v = regs[np.minimum(r, r_n - 1)]
        q = (v & 0xFFFF, v >> 16, np.minimum(total - r * row, row))
        c = q if j == 0 else adler_combine(acc, q)
        acc = tuple(np.where(ok, cc, x) for cc, x in zip(c, acc))
    a, b, _ = block_fold(acc)
    init &= 0xFFFFFFFF
    s1_in, s2_in = init & 0xFFFF, init >> 16
    return int((s2_in + (total % MOD) * s1_in + int(b)) % MOD) << 16 \
        | (s1_in + int(a)) % MOD


def model_adler_buffer(data: bytes, init: int) -> int:
    """The Adler one-buffer route: rows of CHECKSUM_BUFFER_ROW bytes,
    then the fold. The kernel route returns init for an empty buffer."""
    n, row = len(data), CHECKSUM_BUFFER_ROW
    if n == 0:
        return init & 0xFFFFFFFF
    rows = np.zeros((-(-n // row), row), np.uint8)
    rows.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.minimum(n - np.arange(len(rows)) * row, row)
    return model_adler_fold(model_adler_rows(rows, lens, raw=True), n, init)


def _plain_rows(fn, rows, lens, chunk=64):
    """A plain version over rows in chunks (its int64 gathers take 16
    bytes a byte)."""
    return np.concatenate([
        fn(torch.from_numpy(rows[k:k + chunk]),
           torch.from_numpy(lens[k:k + chunk])).numpy()
        for k in range(0, len(rows), chunk)])


def test_model_constants_match_the_kernel():
    """The kernel's X2N literals are x^(2^k) mod P, which repeats with
    period 32 (so k & 31 is exact); its layout constants and the
    operator tables' checked entries are the model's; table 0 is
    CRC_TABLE."""
    src = open(KERNEL).read()
    body = src[src.index("#define X2N_VALUES"):].split("\n__constant__", 1)[0]
    lits = [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]+)u", body)]
    assert lits == X2N.tolist()
    assert multmodp(X2N[31], X2N[31])[()] == X2N[0]
    assert np.array_equal(TABLES[0], CRC_TABLE)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("CRC_THREADS"), const("SPAN"), const("HALF")) == \
        (CRC_THREADS, CHECKSUM_SPAN, HALF)
    assert CRC_THREADS * CHECKSUM_SPAN == CHECKSUM_TILE
    asserted = {m[0]: int(m[1], 16) for m in re.findall(
        r"static_assert\(OPS_HOST\.(\w+\[[\w /]+\]) == 0x([0-9a-f]+)u", src)}
    assert asserted == {"span[1]": int(SPAN_OPS[1]),
                        "span[TILE / SPAN]": int(SPAN_OPS[-1]),
                        "row_hi[1]": int(ROW_HI[1])}
    assert SPAN_OPS[1] == X2N[LOG_SPAN] and SPAN_OPS[-1] == X2N[LOG_TILE]
    assert ROW_HI[1] == X2N[LOG_TILE + 8] and TAIL[1] == X2N[3]


def test_operator_tables_are_the_shifts():
    """Every entry of the operator tables is x^(8 n) for its n, and
    row_shift(m) is x^(8 TILE m) past the tables (buffers over 4 GiB)."""
    assert np.array_equal(TAIL, x8nmodp(np.arange(CHECKSUM_SPAN)))
    assert np.array_equal(SPAN_OPS, x8nmodp(
        CHECKSUM_SPAN * np.arange(len(SPAN_OPS))))
    assert np.array_equal(ROW_LO, x8nmodp(CHECKSUM_TILE * np.arange(256)))
    assert np.array_equal(ROW_HI, x8nmodp(
        CHECKSUM_TILE * 256 * np.arange(256)))
    m = np.array([0, 1, 255, 256, 257, 65535, 65536, 65537, 70000,
                  (1 << 24) + 3, (1 << 31) - 1], np.int64)
    assert np.array_equal(row_shift(m), x8nmodp(CHECKSUM_TILE * m))


def _brev(x):
    """Bit reversal of uint32 values (__brev)."""
    x = np.asarray(x, np.uint64)
    r = np.zeros(x.shape, np.uint64)
    for i in range(32):
        r |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return r


def kernel_mulmod(a, b):
    """The kernel's mulmod: the carry-less product of the bit-reversed
    operands by 16 wrapping 64-bit products of operands masked to every
    fourth bit, the four masked partial sums ORed; its high word times
    x^32 by a slice-by-4 step of zero data (the lane tables), its low
    word added, both reversed back."""
    x, y = _brev(a), _brev(b)
    masks = [np.uint64(0x11111111 << i) for i in range(4)]
    z = [np.zeros(x.shape, np.uint64) for _ in range(4)]
    for i in range(4):
        for k in range(4):
            z[(i + k) & 3] ^= (x & masks[i]) * (y & masks[k])
    q = np.zeros(x.shape, np.uint64)
    for i in range(4):
        q |= z[i] & np.uint64(0x1111111111111111 << i)
    h = _brev(q >> np.uint64(32)).astype(np.uint32)
    t = TABLES
    hi = (t[3, h & 0xFF] ^ t[2, (h >> 8) & 0xFF] ^ t[1, (h >> 16) & 0xFF]
          ^ t[0, h >> 24])
    return hi ^ _brev(q & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def test_integer_carryless_multiply_is_multmodp():
    """The kernel's multiplication equals the bit-serial multmodp on
    random operands and at the edges (0, 1, x^0, all ones)."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    a = np.concatenate([a, np.repeat(edge, 4)])
    b = np.concatenate([b, np.tile(edge, 4)])
    assert np.array_equal(kernel_mulmod(a, b), multmodp(a, b))


def test_lane_tables_meet_no_bank_conflict():
    """The lane-private layout: word (k * 256 + v) * 32 + lane lies in
    bank `lane` whatever k and v, so a warp's 32 lookups meet no
    conflict; the build's 16-byte stores (thread t's i-th at uint4
    (i + t) & 7 of its entry) cover the 32 banks once in each quarter
    warp, whose 8 threads hold 8 neighbouring entries."""
    rng = np.random.default_rng(3)
    lane = np.arange(32)
    for _ in range(64):
        k, v = rng.integers(0, 4), rng.integers(0, 256, 32)
        banks = ((k * 256 + v) * 32 + lane) % 32
        assert np.array_equal(np.sort(banks), lane)
    for t0 in range(0, 1024, 8):
        t = np.arange(t0, t0 + 8)
        entry = (t >> 8) * 256 + (t & 255)
        for i in range(8):
            word = entry * 32 + 4 * ((i + t) & 7)
            banks = (word[:, None] + np.arange(4)) % 32
            assert np.array_equal(np.sort(banks.ravel()), lane)


def test_crc_layout():
    """Threads a row a multiple of HALF, rows a step filling at most 1,024
    threads, one row a step past a tile."""
    assert crc_layout(1024) == (16, 64)
    assert crc_layout(5120) == (80, 12)
    assert crc_layout(CHECKSUM_TILE) == (1024, 1)
    assert crc_layout(CHECKSUM_WIDE) == (1024, 1)
    assert crc_layout(1000) == (16, 64) and crc_layout(0) == (16, 64)


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_model_rows_equal_zlib_and_plain(width):
    """Every CRC span and Adler span boundary +-1, the head and tail
    lengths, s - 1 and s, all-0x00 and all-0xFF rows: the models, zlib
    and the plain versions (int32 and int64 lengths) agree."""
    rows, lens = checksum_rows(width)
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    assert model_crc_rows(rows, lens).tolist() == want_c
    assert model_adler_rows(rows, lens).tolist() == want_a
    for ln in (lens, lens.astype(np.int32)):
        assert _plain_rows(pck.crc32_blocks_plain, rows, ln).tolist() \
            == want_c
        assert _plain_rows(pck.adler32_blocks_plain, rows, ln).tolist() \
            == want_a


def test_model_rows_wider_than_a_tile():
    """Rows of four tiles and a chunk: the register carried from tile to
    tile at every tile edge +-1 and +-a span; the model, zlib and the
    plain versions agree."""
    rows, lens = checksum_wide_rows()
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    assert model_crc_rows(rows, lens).tolist() == want_c
    assert _plain_rows(pck.crc32_blocks_plain, rows, lens).tolist() \
        == want_c
    assert _plain_rows(pck.adler32_blocks_plain, rows, lens).tolist() \
        == want_a


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_plain_rows_equal_jax_on_traps(width):
    """The plain versions equal the JAX functions (under jax.jit, as the
    JAX package's callers run them) on the trap rows, at 64 KiB every
    64th length: the JAX graph's bits take 32 bytes a byte."""
    rows, lens = checksum_rows(width)
    if width == 65536:
        rows, lens = rows[::64], lens[::64]
    lens32 = lens.astype(np.int32)
    for jfn, pfn in ((jck.crc32_blocks, pck.crc32_blocks_plain),
                     (jck.adler32_blocks, pck.adler32_blocks_plain)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(rows),
                                       jnp.asarray(lens32)))
        got = _plain_rows(pfn, rows, lens32)
        assert np.array_equal(got, want.astype(np.int64)), jfn


@pytest.mark.parametrize("index", range(len(checksum_buffers())))
def test_model_buffer_equals_zlib_and_plain(index):
    """The one-buffer route (rows of 64 KiB, the last one short; the CRC
    in one launch, Adler's rows then the one-block fold) at every
    initial value: the models, zlib and the plain versions agree."""
    data = checksum_buffers()[index]
    for init in CHECKSUM_INITS:
        crc, adler = zlib.crc32(data, init), zlib.adler32(data, init)
        assert model_crc_buffer(data, init) == crc, hex(init)
        assert model_adler_buffer(data, init) == adler, hex(init)
        t = pck._padded(data, pck.CRC_CHUNK, "cpu")
        assert int(pck.crc32_fixed_plain(t, len(data), init)) == crc
        assert int(pck.adler32_fixed_plain(t, len(data), init)) == adler


def test_model_fold_of_many_rows():
    """1,030 rows of 64 KiB (row shifts past the low table, 256 and
    up): the CRC route's end and Adler's fold
    (whose threads take five rows each, the last busy one fewer, and the
    threads after it none) on row registers from zlib (the zero-init CRC
    register, Adler from 0)."""
    rng = np.random.default_rng(41)
    row = CHECKSUM_BUFFER_ROW
    data = rng.integers(0, 256, 1029 * row + 77, dtype=np.uint8).tobytes()
    pieces = [data[k:k + row] for k in range(0, len(data), row)]
    assert len(pieces) == 1030
    crc_regs = [zlib.crc32(p, 0xFFFFFFFF) ^ 0xFFFFFFFF for p in pieces]
    adler_regs = [zlib.adler32(p, 0) for p in pieces]
    for init in (0, 0xFFFF0000):
        assert model_crc_buffer_end(crc_regs, len(data), init) == \
            zlib.crc32(data, init)
        assert model_adler_fold(adler_regs, len(data), init) == \
            zlib.adler32(data, init)


def test_model_adler_mod_steps_keep_32_bits():
    """A 2 MiB row of 0xFF (8,192 bytes an Adler thread): the mod steps
    every 4,096 bytes keep the 32-bit sums from wrapping (the model
    asserts it), and the result is zlib's; the CRC's 32 tiles carry the
    register to zlib's."""
    width = 2 << 20
    rows = np.full((1, width), 0xFF, np.uint8)
    for n in (width, width - 1):
        assert model_adler_rows(rows, [n]).tolist() == \
            [zlib.adler32(rows[0, :n].tobytes())]
        assert model_crc_rows(rows, [n]).tolist() == \
            [zlib.crc32(rows[0, :n].tobytes())]


def test_trap_lengths_reach_every_span_edge():
    """checksum_lengths holds each Adler thread's and each CRC span's
    first and last byte, and one byte past it, at every width."""
    for width in CHECKSUM_WIDTHS:
        lens = set(checksum_lengths(width))
        span = width // CHECKSUM_THREADS
        assert all({k * span - 1, k * span, k * span + 1} <= lens
                   for k in range(1, CHECKSUM_THREADS))
        edges = range(CHECKSUM_SPAN, width, CHECKSUM_SPAN)
        assert all({e - 1, e, e + 1} <= lens for e in edges)
        assert {0, width - 1, width} <= lens


def test_dispatchers_on_cpu_equal_plain_without_launches():
    """On CPU tensors the four dispatchers are the plain versions, and
    no kernel launch is counted."""
    before = pck.LAUNCHES
    rows, lens = checksum_rows(5120)
    r, n = torch.from_numpy(rows), torch.from_numpy(lens.astype(np.int32))
    assert torch.equal(pck.crc32_blocks(r, n), pck.crc32_blocks_plain(r, n))
    assert torch.equal(pck.adler32_blocks(r, n),
                       pck.adler32_blocks_plain(r, n))
    for data in checksum_buffers()[1:4]:
        t = pck._padded(data, pck.CRC_CHUNK, "cpu")
        for init in CHECKSUM_INITS:
            assert int(pck.crc32_fixed(t, len(data), init)) == \
                int(pck.crc32_fixed_plain(t, len(data), init))
            assert int(pck.adler32_fixed(t, len(data), init)) == \
                int(pck.adler32_fixed_plain(t, len(data), init))
    assert pck.LAUNCHES == before
