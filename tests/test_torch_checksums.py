"""The device checksums: the port's integer CRC-32 and Adler-32 against
zlib and against the JAX package's functions, on the CPU, at the sizes,
initial values, odd chunk counts and empty input of
tests/test_device_checksums.py; the dispatchers on CPU tensors against
the plain versions; and a numpy model of the CUDA kernel's decomposition
(csrc/checksums.cu: 256 threads a row, each over a contiguous span by
slice-by-8 or the running Adler sums with their mod steps, the spans
folded in shuffle order with multmodp / x2nmodp, one buffer as rows of
64 KiB folded by a 256-thread block) against zlib and the plain
versions on the trap rows and buffers of tests/_port_corpus.py.
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
                          CHECKSUM_THREADS, CHECKSUM_WIDTHS, checksum_buffers,
                          checksum_lengths, checksum_rows)
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


# -- a numpy model of the CUDA kernel's decomposition -------------------------

POLY = 0xEDB88320
MOD = 65521
FOLD_THREADS = 256          # threads of the kernel's one-block fold
ADLER_GROUPS = 256          # 16-byte groups between the Adler mod steps
BATCH = 8                   # 16-byte loads a thread issues together
CRC, ADLER = 0, 1
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
    p = np.full(n.shape, 0x80000000, np.uint32)
    k = 3
    while (n > 0).any():
        take = (n & 1).astype(bool)
        if take.any():
            p = np.where(take, multmodp(X2N[k & 31], p), p)
        n >>= 1
        k += 1
    return p


def _slice8_tables():
    t = np.zeros((8, 256), np.uint32)
    for v in range(256):
        r = v
        for _ in range(8):
            r = (r >> 1) ^ (POLY if r & 1 else 0)
        t[0, v] = r
    for k in range(1, 8):
        t[k] = (t[k - 1] >> np.uint32(8)) ^ t[0, t[k - 1] & 0xFF]
    return t


TABLES = _slice8_tables()


def combine(kind, x, y):
    """The fold step on (a, b, len) parts: CRC a = x^(8 len_y) a_x + a_y
    (skipped shift when len_y is 0); Adler s1, s2 mod 65,521."""
    (xa, xb, xl), (ya, yb, yl) = x, y
    if kind == CRC:
        sh = np.where(yl != 0, multmodp(x8nmodp(yl), xa), xa)
        return sh ^ ya, np.zeros_like(xb), xl + yl
    a = (xa.astype(np.int64) + ya) % MOD
    b = (xb.astype(np.int64) + yb + (yl % MOD) * xa.astype(np.int64)) % MOD
    return a.astype(np.uint32), b.astype(np.uint32), xl + yl


def warp_fold(kind, parts):
    """__shfl_down_sync order over the last axis (32 lanes): lane 0's
    result."""
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        src = np.where(lane + off < 32, lane + off, lane)
        q = tuple(x[..., src] for x in parts)
        c = combine(kind, parts, q)
        take = (lane % (2 * off)) == 0
        parts = tuple(np.where(take, cc, x) for cc, x in zip(c, parts))
    return tuple(x[..., 0] for x in parts)


def block_fold(kind, parts):
    """The block's fold over the last axis (its threads): each warp,
    then warp 0 over the warps' results, lanes past them empty."""
    t = parts[0].shape[-1]
    w = tuple(x.reshape(*x.shape[:-1], t // 32, 32) for x in parts)
    w = warp_fold(kind, w)
    pad = [(0, 0)] * (w[0].ndim - 1) + [(0, 32 - t // 32)]
    return warp_fold(kind, tuple(np.pad(x, pad) for x in w))


def span_parts(kind, rows, lens, c0=0):
    """Each thread's part of rows (R, s) uint8 cut at lens (R,): head
    bytes to a 16-byte boundary (rows start aligned), batches of BATCH
    16-byte groups, single groups, tail bytes; Adler's sums reduced once
    ADLER_GROUPS groups are in, checked to stay below 2^32. Thread 0's
    CRC register starts at c0."""
    r_n, s = rows.shape
    span = -(-s // CHECKSUM_THREADS)
    b0 = np.arange(CHECKSUM_THREADS, dtype=np.int64) * span
    ln = np.asarray(lens, np.int64)[:, None]
    begin, end = np.minimum(b0, ln), np.minimum(b0 + span, ln)
    i = begin.copy()
    rr = np.arange(r_n)[:, None]
    c = np.zeros(begin.shape, np.uint32)
    c[:, 0] = c0
    s1 = np.zeros(begin.shape, np.int64)
    s2 = np.zeros(begin.shape, np.int64)

    def byte_step(m):
        nonlocal c, s1, s2
        d = rows[rr, np.minimum(i, s - 1)].astype(np.uint32)
        if kind == CRC:
            c = np.where(m, TABLES[0, (c ^ d) & 0xFF] ^ (c >> np.uint32(8)), c)
        else:
            s1 = np.where(m, s1 + d, s1)
            s2 = np.where(m, s2 + s1, s2)

    def crc_8(c, lo, hi):
        c = c ^ lo
        t = TABLES
        return (t[7, c & 0xFF] ^ t[6, (c >> 8) & 0xFF] ^ t[5, (c >> 16) & 0xFF]
                ^ t[4, c >> 24] ^ t[3, hi & 0xFF] ^ t[2, (hi >> 8) & 0xFF]
                ^ t[1, (hi >> 16) & 0xFF] ^ t[0, hi >> 24])

    def groups_step(m, count):
        """count 16-byte groups where m, then Adler's mod check."""
        nonlocal c, s1, s2, i
        for _ in range(count):
            d = rows[rr[..., None], np.minimum(i[..., None] + np.arange(16),
                                               s - 1)]
            if kind == CRC:
                w = d.astype(np.uint32)
                w = w[..., 0::4] | w[..., 1::4] << 8 | w[..., 2::4] << 16 \
                    | w[..., 3::4] << 24
                step = crc_8(crc_8(c, w[..., 0], w[..., 1]), w[..., 2],
                             w[..., 3])
                c = np.where(m, step, c)
            else:
                for k in range(16):
                    s1 = np.where(m, s1 + d[..., k], s1)
                    s2 = np.where(m, s2 + s1, s2)
                assert s2.max(initial=0) < 1 << 32
            i += 16 * m
        if kind == ADLER:
            groups[:] += count * m
            wrap = groups >= ADLER_GROUPS
            s1, s2 = np.where(wrap, s1 % MOD, s1), np.where(wrap, s2 % MOD, s2)
            groups[wrap] = 0

    while ((m := (i < end) & (i % 16 != 0))).any():
        byte_step(m)
        i += m
    groups = np.zeros(begin.shape, np.int64)
    while ((m := i + 16 * BATCH <= end)).any():
        groups_step(m, BATCH)
    while ((m := i + 16 <= end)).any():
        groups_step(m, 1)
    while ((m := i < end)).any():
        byte_step(m)
        i += m
    assert s2.max(initial=0) < 1 << 32
    length = np.maximum(end - begin, 0)
    if kind == CRC:
        return c, np.zeros_like(c), length
    return (s1 % MOD).astype(np.uint32), (s2 % MOD).astype(np.uint32), length


def model_rows(kind, rows, lens, raw=False):
    """The row kernel: each row's CRC-32 (thread 0's span from the
    initial register 0xFFFFFFFF) / Adler-32, or with raw its zero-init
    register / (s2 << 16 | s1) from zero; int64 (R,)."""
    lens = np.clip(np.asarray(lens, np.int64), 0, rows.shape[1])
    c0 = 0 if raw or kind != CRC else 0xFFFFFFFF
    a, b, _ = block_fold(kind, span_parts(kind, rows, lens, c0))
    if kind == CRC:
        return (a if raw else a ^ np.uint32(0xFFFFFFFF)).astype(np.int64)
    if raw:
        return b.astype(np.int64) << 16 | a
    return ((b.astype(np.int64) + lens % MOD) % MOD) << 16 \
        | (1 + a.astype(np.int64)) % MOD


def model_fold(kind, regs, total, init):
    """The one-block fold of one buffer's raw row registers (rows of
    CHECKSUM_BUFFER_ROW bytes, the last one short), then the initial
    value."""
    regs = np.asarray(regs, np.int64)
    r_n, row = len(regs), CHECKSUM_BUFFER_ROW
    per = -(-r_n // FOLD_THREADS)
    t = np.arange(FOLD_THREADS)
    r0 = t * per
    r1 = np.minimum(r0 + per, r_n)
    acc = (np.zeros(FOLD_THREADS, np.uint32),
           np.zeros(FOLD_THREADS, np.uint32),
           np.zeros(FOLD_THREADS, np.int64))
    for j in range(per):
        r = r0 + j
        ok = r < r1
        v = regs[np.minimum(r, r_n - 1)].astype(np.uint32)
        q = (v if kind == CRC else v & 0xFFFF,
             np.zeros_like(v) if kind == CRC else v >> 16,
             np.minimum(total - r * row, row))
        c = q if j == 0 else combine(kind, acc, q)
        acc = tuple(np.where(ok, cc, x) for cc, x in zip(c, acc))
    a, b, _ = block_fold(kind, acc)
    init &= 0xFFFFFFFF
    if kind == CRC:
        return int(multmodp(x8nmodp(total), np.uint32(init ^ 0xFFFFFFFF))
                   ^ a ^ np.uint32(0xFFFFFFFF))
    s1_in, s2_in = init & 0xFFFF, init >> 16
    return int((s2_in + (total % MOD) * s1_in + int(b)) % MOD) << 16 \
        | (s1_in + int(a)) % MOD


def model_buffer(kind, data: bytes, init: int) -> int:
    """The one-buffer path: rows of CHECKSUM_BUFFER_ROW bytes, then the
    fold. The kernel path returns init for an empty buffer."""
    n, row = len(data), CHECKSUM_BUFFER_ROW
    if n == 0:
        return init & 0xFFFFFFFF
    rows = np.zeros((-(-n // row), row), np.uint8)
    rows.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.minimum(n - np.arange(len(rows)) * row, row)
    return model_fold(kind, model_rows(kind, rows, lens, raw=True), n, init)


def _plain_rows(fn, rows, lens, chunk=64):
    """A plain version over rows in chunks (its int64 gathers take 16
    bytes a byte)."""
    return np.concatenate([
        fn(torch.from_numpy(rows[k:k + chunk]),
           torch.from_numpy(lens[k:k + chunk])).numpy()
        for k in range(0, len(rows), chunk)])


def test_model_constants_match_the_kernel():
    """The kernel's X2N literals are x^(2^k) mod P, which repeats with
    period 32 (so k & 31 is exact); the slice-by-8 base table is
    CRC_TABLE."""
    src = open(KERNEL).read()
    body = src[src.index("#define X2N_VALUES"):].split("\n__constant__", 1)[0]
    lits = [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]+)u", body)]
    assert lits == X2N.tolist()
    assert multmodp(X2N[31], X2N[31])[()] == X2N[0]
    assert np.array_equal(TABLES[0], CRC_TABLE)


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_model_rows_equal_zlib_and_plain(width):
    """Every span boundary +-1, the head and tail lengths, s - 1 and s,
    all-0x00 and all-0xFF rows: the model, zlib and the plain versions
    (int32 and int64 lengths) agree."""
    rows, lens = checksum_rows(width)
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    assert model_rows(CRC, rows, lens).tolist() == want_c
    assert model_rows(ADLER, rows, lens).tolist() == want_a
    for ln in (lens, lens.astype(np.int32)):
        assert _plain_rows(pck.crc32_blocks_plain, rows, ln).tolist() \
            == want_c
        assert _plain_rows(pck.adler32_blocks_plain, rows, ln).tolist() \
            == want_a


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_plain_rows_equal_jax_on_traps(width):
    """The plain versions equal the JAX functions (under jax.jit, as the
    JAX package's callers run them) on the trap rows, at 64 KiB every
    16th length: the JAX graph's bits take 32 bytes a byte."""
    rows, lens = checksum_rows(width)
    if width == 65536:
        rows, lens = rows[::16], lens[::16]
    lens32 = lens.astype(np.int32)
    for jfn, pfn in ((jck.crc32_blocks, pck.crc32_blocks_plain),
                     (jck.adler32_blocks, pck.adler32_blocks_plain)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(rows),
                                       jnp.asarray(lens32)))
        got = _plain_rows(pfn, rows, lens32)
        assert np.array_equal(got, want.astype(np.int64)), jfn


@pytest.mark.parametrize("index", range(len(checksum_buffers())))
def test_model_buffer_equals_zlib_and_plain(index):
    """The one-buffer path (rows of 64 KiB, the last one short, then the
    one-block fold) at every initial value: the model, zlib and the
    plain versions agree."""
    data = checksum_buffers()[index]
    for init in CHECKSUM_INITS:
        crc, adler = zlib.crc32(data, init), zlib.adler32(data, init)
        assert model_buffer(CRC, data, init) == crc, hex(init)
        assert model_buffer(ADLER, data, init) == adler, hex(init)
        t = pck._padded(data, pck.CRC_CHUNK, "cpu")
        assert int(pck.crc32_fixed_plain(t, len(data), init)) == crc
        assert int(pck.adler32_fixed_plain(t, len(data), init)) == adler


def test_model_fold_of_many_rows():
    """1,030 rows: the fold's threads take five rows each, the last busy
    one fewer, and the threads after it none. Row registers from zlib
    (the zero-init CRC register, Adler from 0)."""
    rng = np.random.default_rng(41)
    row = CHECKSUM_BUFFER_ROW
    data = rng.integers(0, 256, 1029 * row + 77, dtype=np.uint8).tobytes()
    pieces = [data[k:k + row] for k in range(0, len(data), row)]
    assert len(pieces) == 1030
    crc_regs = [zlib.crc32(p, 0xFFFFFFFF) ^ 0xFFFFFFFF for p in pieces]
    adler_regs = [zlib.adler32(p, 0) for p in pieces]
    for init in (0, 0xFFFF0000):
        assert model_fold(CRC, crc_regs, len(data), init) == \
            zlib.crc32(data, init)
        assert model_fold(ADLER, adler_regs, len(data), init) == \
            zlib.adler32(data, init)


def test_model_adler_mod_steps_keep_32_bits():
    """A 2 MiB row of 0xFF (8,192 bytes a thread): the mod steps every
    4,096 bytes keep the 32-bit sums from wrapping (the model asserts
    it), and the result is zlib's."""
    width = 2 << 20
    rows = np.full((1, width), 0xFF, np.uint8)
    for n in (width, width - 1):
        assert model_rows(ADLER, rows, [n]).tolist() == \
            [zlib.adler32(rows[0, :n].tobytes())]
        assert model_rows(CRC, rows, [n]).tolist() == \
            [zlib.crc32(rows[0, :n].tobytes())]


def test_trap_lengths_reach_every_span_edge():
    """checksum_lengths holds each thread's first and last byte."""
    for s in CHECKSUM_WIDTHS:
        span = s // CHECKSUM_THREADS
        lens = set(checksum_lengths(s))
        assert all({k * span - 1, k * span, k * span + 1} <= lens
                   for k in range(1, CHECKSUM_THREADS))


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
