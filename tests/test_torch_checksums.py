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
- Adler-32: tiles of 64 KiB of a row, cut at its length; thread t's
  16-byte groups t + 256 k summed by dp4a (the byte sum and the sum
  weighted 16 .. 1, r += s1 before each group) in 32 bits with one
  reduction, checked against the worst case; the group the length cuts
  from single bytes; each thread's part weighted to the tile's full end,
  the block's parts only added; a row of one tile ended in its block, a
  longer row's tile terms added by atomics in any order and ended by the
  last; one buffer as one row from its initial value.
Tolerance: exact equality."""

import os
import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_corpus import (CHECKSUM_BUFFER_ROW, CHECKSUM_GROUP,
                          CHECKSUM_INITS, CHECKSUM_NMAX, CHECKSUM_SPAN,
                          CHECKSUM_THREADS, CHECKSUM_TILE, CHECKSUM_WIDE,
                          CHECKSUM_WIDTHS, adler_trap_groups,
                          checksum_buffers, checksum_ff_rows,
                          checksum_lengths, checksum_odd_stride,
                          checksum_rows, checksum_wide_rows)
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


ADLER_WORDS = (0x01010101,) * 4                          # s1's dp4a weights
WEIGHT_WORDS = (0x0D0E0F10, 0x090A0B0C, 0x05060708, 0x01020304)  # 16 .. 1
STRIDE = CHECKSUM_GROUP * CHECKSUM_THREADS   # bytes from a slot to the next
SLOTS = CHECKSUM_TILE // STRIDE              # groups a thread a tile
U32 = 1 << 32
#: a thread's worst case (every byte 0xFF) before its one reduction: s1,
#: and b = w + E s1 + STRIDE r + the cut group's term
A_MAX = SLOTS * CHECKSUM_GROUP * 255
B_MAX = (SLOTS * 136 * 255 + CHECKSUM_GROUP * CHECKSUM_THREADS * A_MAX
         + STRIDE * CHECKSUM_GROUP * 255 * SLOTS * (SLOTS - 1) // 2
         + (CHECKSUM_GROUP - 1) * 255 * CHECKSUM_TILE + 135 * 255)


def dp4a(a, b, c):
    """__dp4a(unsigned, unsigned, unsigned), elementwise: c plus the
    products of a's and b's bytes; checked not to wrap."""
    out = np.asarray(c, np.uint64).copy()
    for i in range(4):
        out = out + ((np.asarray(a, np.uint64) >> np.uint64(8 * i)) & 255) \
            * ((np.uint64(b) >> np.uint64(8 * i)) & 255)
    assert out.max(initial=0) < U32
    return out.astype(np.uint32)


def group_sums(words, s1, w):
    """One group (..., 4) uint32 words: s1 + its byte sum and w + its sum
    weighted 16 .. 1, four dp4a each."""
    for k in range(4):
        s1 = dp4a(words[..., k], ADLER_WORDS[k], s1)
        w = dp4a(words[..., k], WEIGHT_WORDS[k], w)
    return s1, w


def adler_tile_parts(tiles, lens):
    """Each thread's (a, b) over tiles (M, CHECKSUM_TILE) uint8 cut at lens
    (M,): thread t's groups t + 256 k whole inside the length (16-byte
    loads), r += s1 before each, the group the length cuts summed by its
    owner from single bytes; b = w + E s1 + STRIDE r + the cut group's
    term, with E the bytes after its last slot, checked below 2^32 and
    reduced once. Bytes past the length are not read."""
    m_n = len(tiles)
    lens = np.asarray(lens, np.int64)
    t = np.arange(CHECKSUM_THREADS)
    at = np.arange(m_n)[:, None]
    words = np.ascontiguousarray(tiles).view("<u4").reshape(
        m_n, SLOTS, CHECKSUM_THREADS, 4)
    s1 = np.zeros((m_n, CHECKSUM_THREADS), np.uint32)
    r = np.zeros_like(s1)
    w = np.zeros_like(s1)
    for k in range(SLOTS):
        whole = CHECKSUM_GROUP * (t + CHECKSUM_THREADS * k) \
            + CHECKSUM_GROUP <= lens[:, None]
        r = (r.astype(np.uint64) + s1).astype(np.uint32)
        s1, w = group_sums(np.where(whole[..., None], words[:, k], 0), s1, w)
    cut = lens & ~(CHECKSUM_GROUP - 1)
    m = lens & (CHECKSUM_GROUP - 1)
    owner = (cut // CHECKSUM_GROUP) % CHECKSUM_THREADS
    idx = np.minimum(cut[:, None] + np.arange(CHECKSUM_GROUP),
                     CHECKSUM_TILE - 1)
    cut_bytes = np.where(np.arange(CHECKSUM_GROUP) < m[:, None],
                         tiles[at, idx], 0).astype(np.uint8)
    cw = np.ascontiguousarray(cut_bytes).view("<u4")
    has = (m[:, None] > 0) & (t == owner[:, None])
    ac, wc = group_sums(np.where(has[..., None], cw[:, None, :], 0), 0, 0)
    e = (CHECKSUM_GROUP * (CHECKSUM_THREADS - 1 - t)).astype(np.uint64)
    after_cut = (CHECKSUM_TILE - CHECKSUM_GROUP - cut).astype(np.uint64)
    b = (w.astype(np.uint64) + e * s1 + np.uint64(STRIDE) * r + wc
         + ac.astype(np.uint64) * after_cut[:, None])
    assert b.max(initial=0) < U32 and b.max(initial=0) <= B_MAX
    a = s1.astype(np.uint64) + ac
    assert a.max(initial=0) < MOD
    return a, b % MOD


def adler_tile_terms(tiles, lens, n, start):
    """Each tile's term for its row: the block's sums (shuffles and shared
    memory, 32-bit) of its threads' parts, A, and B moved past the bytes
    after the tile's full end, f = (n - start - CHECKSUM_TILE) mod
    65,521: (A, (B + A f) mod 65,521), each checked below 2^32."""
    a, b = adler_tile_parts(tiles, lens)
    big_a, big_b = a.sum(-1), b.sum(-1)
    assert max(big_a.max(initial=0), big_b.max(initial=0)) < U32
    big_a, big_b = big_a % MOD, big_b % MOD
    f = (((np.asarray(n, np.int64) - start) % MOD + MOD
          - CHECKSUM_TILE % MOD) % MOD).astype(np.uint64)
    assert (big_b + big_a * f).max(initial=0) < U32
    return big_a, (big_b + big_a * f) % MOD


def adler_finish(n, big_a, big_b, init):
    """The row's Adler-32 from its sums and the initial value."""
    s1_in, s2_in = init & 0xFFFF, init >> 16
    return ((s2_in + (n % MOD) * s1_in + big_b) % MOD) << 16 \
        | (s1_in + big_a) % MOD


def model_adler_rows(rows, lens, init=1, seed=0, chunk=256):
    """The Adler kernel on rows (R, s) uint8 cut at lens: each row's
    Adler-32 from `init` (int64 (R,)). A row's tiles are those below
    max(1, ceil(n / CHECKSUM_TILE)); a row of one tile ends in its block,
    a longer row's tiles add their terms in a seeded order (the blocks',
    any) into two 64-bit words and a counter, the last to finish ending
    it."""
    r_n, s = rows.shape
    lens = np.clip(np.asarray(lens, np.int64), 0, s)
    per_row = max(1, -(-s // CHECKSUM_TILE))
    wide = per_row * CHECKSUM_TILE
    n_tiles = np.maximum(1, -(-lens // CHECKSUM_TILE))
    terms = {}
    for c in range(per_row):
        live = np.flatnonzero(c < n_tiles)
        for k in range(0, len(live), chunk):
            at = live[k:k + chunk]
            tiles = np.zeros((len(at), CHECKSUM_TILE), np.uint8)
            part = rows[at, c * CHECKSUM_TILE:(c + 1) * CHECKSUM_TILE]
            tiles[:, :part.shape[1]] = part
            start = c * CHECKSUM_TILE
            big_a, big_b = adler_tile_terms(
                tiles, np.clip(lens[at] - start, 0, CHECKSUM_TILE),
                lens[at], start)
            for i, row in enumerate(at):
                terms[int(row), c] = (int(big_a[i]), int(big_b[i]))
    out = np.zeros(r_n, np.int64)
    acc = {}
    order = list(terms)
    np.random.default_rng(seed).shuffle(order)
    for row, c in order:
        n, (big_a, big_b) = int(lens[row]), terms[row, c]
        if n <= CHECKSUM_TILE:
            out[row] = adler_finish(n, big_a, big_b, init)
            continue
        sa, sb, done = acc.get(row, (0, 0, 0))
        sa, sb, done = sa + big_a, sb + big_b, done + 1
        assert sa < 1 << 64 and sb < 1 << 64
        acc[row] = (sa, sb, done)
        if done == n_tiles[row]:
            acc.pop(row)
            out[row] = adler_finish(n, sa % MOD, sb % MOD, init)
    assert not acc
    return out


def model_adler_buffer(data: bytes, init: int, seed=0) -> int:
    """The Adler one-buffer route: one row of the buffer's length, from
    `init`, in the same kernel. The route returns init for an empty
    buffer without a launch."""
    if not data:
        return init & 0xFFFFFFFF
    row = np.frombuffer(data, np.uint8)[None]
    return int(model_adler_rows(row, [len(data)], init & 0xFFFFFFFF,
                                seed)[0])


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
    assert (const("ADLER_THREADS"), const("GROUP"),
            const("ADLER_TILE")) == (CHECKSUM_THREADS, CHECKSUM_GROUP,
                                     CHECKSUM_TILE)
    words = dict(re.findall(r"(W\d|ONES) = (0x[0-9A-F]+)u", src))
    assert [int(words[f"W{k}"], 16) for k in range(4)] == list(WEIGHT_WORDS)
    assert int(words["ONES"], 16) == ADLER_WORDS[0]
    for k, word in enumerate(WEIGHT_WORDS):
        assert [(word >> 8 * i) & 255 for i in range(4)] == \
            [16 - 4 * k - i for i in range(4)]
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
    """Every CRC span edge and one Adler group edge of every thread +-1,
    zlib's NMAX and its multiples +-1, the bytes around a 16-byte load, s
    - 1 and s, all-0x00 and all-0xFF rows: the models, zlib and the
    plain versions (int32 and int64 lengths) agree."""
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
    """Rows of four tiles and a chunk: the CRC register carried from tile
    to tile, Adler's tile terms added into the row's words in two seeded
    orders, at every tile edge +-1 and +-a span; the models, zlib and the
    plain versions agree."""
    rows, lens = checksum_wide_rows()
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    assert model_crc_rows(rows, lens).tolist() == want_c
    for seed in (0, 1):
        assert model_adler_rows(rows, lens, seed=seed).tolist() == want_a
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
    """The one-buffer route (tiles of 64 KiB, the last one short, in one
    launch) at every initial value: the models, zlib and the plain
    versions agree."""
    data = checksum_buffers()[index]
    for init in CHECKSUM_INITS:
        crc, adler = zlib.crc32(data, init), zlib.adler32(data, init)
        assert model_crc_buffer(data, init) == crc, hex(init)
        assert model_adler_buffer(data, init) == adler, hex(init)
        assert model_adler_buffer(data, init, seed=1) == adler
        t = pck._padded(data, pck.CRC_CHUNK, "cpu")
        assert int(pck.crc32_fixed_plain(t, len(data), init)) == crc
        assert int(pck.adler32_fixed_plain(t, len(data), init)) == adler


def test_model_fold_of_many_rows():
    """1,030 rows of 64 KiB (row shifts past the low table, 256 and up):
    the CRC route's end on row registers from zlib (the zero-init
    register); Adler's end of one buffer of 1,030 tiles (the two words
    and the counter), each tile's term from zlib's
    zero-start sums of its bytes (A, and B moved to the buffer's end),
    added in four seeded orders, the last tile ending it."""
    rng = np.random.default_rng(41)
    row = CHECKSUM_BUFFER_ROW
    data = rng.integers(0, 256, 1029 * row + 77, dtype=np.uint8).tobytes()
    pieces = [data[k:k + row] for k in range(0, len(data), row)]
    assert len(pieces) == 1030
    crc_regs = [zlib.crc32(p, 0xFFFFFFFF) ^ 0xFFFFFFFF for p in pieces]
    n = len(data)
    terms = []
    for k, p in enumerate(pieces):
        v = zlib.adler32(p, 0)
        big_a, big_b = v & 0xFFFF, v >> 16
        terms.append((big_a, (big_b + big_a * (n - k * row - len(p))) % MOD))
    for init in (0, 0xFFFF0000):
        assert model_crc_buffer_end(crc_regs, len(data), init) == \
            zlib.crc32(data, init)
        for seed in range(4):
            order = np.random.default_rng(seed).permutation(len(terms))
            sa = sb = done = 0
            for k in order:
                sa, sb, done = sa + terms[k][0], sb + terms[k][1], done + 1
                assert sa < 1 << 64 and sb < 1 << 64
            assert done == -(-n // CHECKSUM_TILE) == 1030
            assert adler_finish(n, sa % MOD, sb % MOD, init) == \
                zlib.adler32(data, init)


@pytest.mark.parametrize("tiles", [1, 2, 3, 32])
def test_model_adler_mod_steps_keep_32_bits(tiles):
    """All-0xFF rows (checksum_ff_rows) of one, two and three tiles, and
    a 2 MiB row of 0xFF (32 tiles), each also one byte short: a thread's
    32-bit sums stay below the stated bound B_MAX < 2^32 with one
    reduction (the model asserts it, and the worst thread reaches within
    a cut group's term of it), the row's 64-bit words do not wrap, and
    the results are zlib's; the CRC's tiles carry the register to
    zlib's."""
    assert A_MAX < MOD and B_MAX < U32
    if tiles == 32:
        rows = np.full((2, tiles * CHECKSUM_TILE), 0xFF, np.uint8)
        lens = np.array([rows.shape[1], rows.shape[1] - 1], np.int64)
        rows[1, -1] = 0
    else:
        rows, lens = checksum_ff_rows()
        pick = (lens + CHECKSUM_TILE - 1) // CHECKSUM_TILE == tiles
        rows, lens = rows[pick], lens[pick]
    want = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    assert model_adler_rows(rows, lens).tolist() == want
    assert model_crc_rows(rows, lens).tolist() == \
        [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    a, b = adler_tile_parts(np.full((1, CHECKSUM_TILE), 0xFF, np.uint8),
                            [CHECKSUM_TILE])
    cut_term = (CHECKSUM_GROUP - 1) * 255 * CHECKSUM_TILE + 135 * 255
    worst = (SLOTS * 136 * 255 + CHECKSUM_GROUP * (CHECKSUM_THREADS - 1)
             * A_MAX + STRIDE * CHECKSUM_GROUP * 255 * SLOTS * (SLOTS - 1)
             // 2)
    assert worst <= B_MAX - cut_term and int(a.max()) == A_MAX


def test_trap_lengths_reach_every_span_edge():
    """checksum_lengths holds, at every width, one byte either side of
    the start of one Adler group of every thread, each of a tile's 16
    slots reached (at 64 KiB, 16 times), zlib's NMAX and its multiples,
    and each CRC span's first and last byte and one byte past it."""
    for width in CHECKSUM_WIDTHS:
        lens = set(checksum_lengths(width))
        groups = adler_trap_groups(width)
        tile_groups = -(-min(width, CHECKSUM_TILE) // CHECKSUM_GROUP)
        assert sorted(g % CHECKSUM_THREADS for g in groups) == \
            list(range(min(tile_groups, CHECKSUM_THREADS)))
        assert all({16 * g - 1, 16 * g, 16 * g + 1} - {-1} <= lens
                   for g in groups)
        slots = {g // CHECKSUM_THREADS for g in groups}
        assert slots == set(range(-(-tile_groups // CHECKSUM_THREADS)))
        nmax = range(CHECKSUM_NMAX, width + 1, CHECKSUM_NMAX)
        assert all({e - 1, e, e + 1} - {width + 1} <= lens for e in nmax)
        edges = range(CHECKSUM_SPAN, width, CHECKSUM_SPAN)
        assert all({e - 1, e, e + 1} <= lens for e in edges)
        assert {0, width - 1, width} <= lens
    assert sum(len(range(CHECKSUM_NMAX, w + 1, CHECKSUM_NMAX))
               for w in CHECKSUM_WIDTHS) == 11
    assert sorted(g // CHECKSUM_THREADS
                  for g in adler_trap_groups(CHECKSUM_TILE)) == \
        sorted(list(range(SLOTS)) * (CHECKSUM_THREADS // SLOTS))


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_model_adler_reads_no_padding(width):
    """The trap rows with random bytes past each length (the kernel cuts
    every tile at its row's length and reads nothing past it): the model
    still gives zlib's Adler-32 of each row's first bytes, in two seeded
    tile orders."""
    rows, lens = checksum_rows(width)
    want = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    rng = np.random.default_rng(width)
    noisy = rng.integers(0, 256, rows.shape, dtype=np.uint8)
    keep = np.arange(width) < lens[:, None]
    noisy = np.where(keep, rows, noisy)
    for seed in (1, 2):
        assert model_adler_rows(noisy, lens, seed=seed).tolist() == want


def test_model_adler_odd_stride_rows():
    """checksum_odd_stride: rows read as a view at an odd stride (every
    row at another offset mod 16, the kernel's single-byte loads), random
    bytes past each length: the model on the view, zlib and the plain
    version on the zero-padded rows agree."""
    store, lens = checksum_odd_stride()
    view = store[:, :-1]
    assert view.strides[0] % 2 == 1
    want = [zlib.adler32(r[:n].tobytes()) for r, n in zip(view, lens)]
    assert model_adler_rows(view, lens).tolist() == want
    zeroed = np.where(np.arange(view.shape[1]) < lens[:, None], view, 0)
    assert _plain_rows(pck.adler32_blocks_plain, zeroed.astype(np.uint8),
                       lens).tolist() == want


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
