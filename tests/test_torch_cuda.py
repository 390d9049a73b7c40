"""The port on a CUDA card: the pass-1, inflate_v2, inflate_static,
dyn_tables, assembly, resolve, match_l6, match_v2, select, emit and
checksum kernels against
their plain PyTorch versions on the card, the slice through the
kernels, the level 0-6 compress tiers (card bytes equal to CPU bytes,
decoded through the kernels) and the device checksums under TF32 and
bf16 matmul precision. Every test here needs a card and skips without
one.

Run on a machine with a card (the suite's conftest.py imports jax, which
such a machine need not have): python -m pytest --noconftest
tests/test_torch_cuda.py
"""

import random
import zlib

import numpy as np
import pytest
import torch

from _port_corpus import (CHECKSUM_INITS, CHECKSUM_TILE, CHECKSUM_WIDTHS,
                          RESOLVE_CASES, V2_SIZES, checksum_buffers,
                          checksum_ff_rows, checksum_odd_stride,
                          checksum_rows, checksum_wide_rows,
                          cut_stored_streams,
                          edge_cases, edge_rows, emit_cases,
                          emit_chunk_cases, emit_pass_inputs,
                          emit_random_cases, emit_unaligned, l6_windows,
                          make_corpus, mutated_streams, select_cases,
                          select_tile_cases, v2_cases)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _z(data, level=6):
    return zlib.compress(data, level)[2:-4]


def _cases():
    streams = []
    for lvl in (0, 1, 6, 9):
        for kind in ("text", "random", "pattern", "zeros", "periodic:7"):
            streams.append(_z(make_corpus(kind, 2000 + 37 * lvl, seed=lvl),
                              lvl))
    r = random.Random(11)
    good = make_corpus("text", 3000, seed=1)
    streams += [bytes(r.randrange(256) for _ in range(600)),
                _z(good)[:250], b"\x07\x00", _z(b""), _z(b"x")]
    return streams + mutated_streams(96, seed=6)


@pytest.mark.parametrize("out_cap", [1024, 65536, 1 << 20])
def test_kernel_equals_plain_on_card(card, out_cap):
    """Tokens and stats equal, including streams that overflow out_cap
    and malformed ones; the kernel launch is counted."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams(_cases(), 65536, card)[:3]
    before = it.LAUNCHES
    tok_k, st_k = it.pass1(*args, out_cap)
    assert it.LAUNCHES == before + 1
    tok_p, st_p = it.pass1_plain(*args, out_cap)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_p)
    assert torch.equal(tok_k, tok_p)


@pytest.mark.parametrize("out_cap", [2500, 65536])
def test_segment_route_equals_plain_on_card(card, out_cap):
    """The segment route's kernels against the whole-stream plain version
    on streams with sync points (false candidates, matches across sync
    points, out_cap in a later segment, bit-flipped), in one launch, and
    the serial route (sync stops off) likewise."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from test_torch_pass1_segments import bit_flipped, sync_cases

    streams = [z for _, z, _ in sync_cases()] + bit_flipped(24) + _cases()
    args = it.pack_streams(streams, 65536, card)[:3]
    tok_p, st_p = it.pass1_plain(*args, out_cap)
    segs, reruns = it.SEGMENTS, it.RERUNS
    for sync in (True, False):
        tok_k, st_k = it.pass1(*args, out_cap, _sync_stops=sync)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p)
        assert torch.equal(tok_k, tok_p)
    assert it.SEGMENTS > segs + 2 * len(streams) and it.RERUNS > reruns


def test_kernel_rejects_cut_stored_streams_on_card(card):
    """Streams whose final stored block is cut by one byte: the kernel
    equals the plain version (every one BAD) on both routes, and the
    two-pass decoder gives None for each, counted as a pass-1 fallback,
    in both resolve modes."""
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    cut = cut_stored_streams()
    streams = [z for z, _ in cut] + [z + d[-1:] for z, d in cut]
    args = it.pack_streams(streams, 65536, card)[:3]
    tok_p, st_p = it.pass1_plain(*args, 65536)
    n = len(cut)
    assert st_p[:n, 0].tolist() == [it.BAD] * n
    assert st_p[n:, 0].tolist() == [it.DONE] * n
    for sync in (True, False):
        tok_k, st_k = it.pass1(*args, 65536, _sync_stops=sync)
        torch.cuda.synchronize()
        assert torch.equal(st_k, st_p)
        assert torch.equal(tok_k, tok_p)
    for resolve in ("device", "host"):
        bd = BatchDecompressor(use_device=True, resolve=resolve, device=card)
        got = bd.decompress_batch(streams, [len(d) for _, d in cut] * 2)
        assert got == [None] * n + [d for _, d in cut]
        assert dict(bd.fallbacks) == {"pass1": n}


def test_empty_batch_launches_nothing(card):
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams([], 65536, card)[:3]
    before = it.LAUNCHES
    tokens, stats = it.pass1(*args, 64)
    assert tokens.shape == (0, 64) and stats.shape == (0, 4)
    assert it.LAUNCHES == before


def test_slice_on_card_equals_slice_on_cpu(card):
    from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor

    datas = [make_corpus("text", 70000, seed=1), make_corpus("pattern", 9000),
             make_corpus("random", 3000, seed=2)]
    gpu = BatchCompressor(level=6, use_device=True,
                          device=card).compress_batch(datas)
    cpu = BatchCompressor(level=6, use_device=True,
                          device="cpu").compress_batch(datas)
    assert gpu == cpu
    # 4 items take the small-batch decoder (the 70000-byte item passes its
    # output cap), 8 the two-pass decoder
    inputs = gpu + [b"\xff\x07garbage"]
    caps = [len(d) for d in datas] + [100]
    bd = BatchDecompressor(use_device=True, device=card)
    assert bd.decompress_batch(inputs, caps) == datas + [None]
    assert dict(bd.fallbacks) == {"out_cap": 1, "v2": 1}
    for resolve in ("device", "host"):
        bd = BatchDecompressor(use_device=True, resolve=resolve, device=card)
        got = bd.decompress_batch(inputs * 2, caps * 2)
        assert got == (datas + [None]) * 2
        assert dict(bd.fallbacks) == {"pass1": 2}


def _stream_cases():
    """Streams for the two stream kernels: every block type, malformed,
    bit-flipped, and output past the 64 KiB caps."""
    def fixed(d):
        c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
        return c.compress(d) + c.flush()

    d = make_corpus("text", 60000, seed=3)
    return _cases() + [fixed(d), _z(d, 0)[:30000], _z(d, 9), _z(bytes(70000)),
                       fixed(bytes(66100)), b""]


def _edge_batch(card):
    lens, words = edge_rows(edge_cases())
    return torch.from_numpy(lens).to(card), torch.from_numpy(words).to(card)


@pytest.mark.parametrize("batch", ["cases", "one", "edge"])
@pytest.mark.parametrize("name", ["inflate_v2", "inflate_static"])
def test_stream_kernel_equals_plain_on_card(card, name, batch):
    """Every output word equal (bytes, flags, count), and the launch
    counted: the mixed cases, a batch of 1, and the hand-built edge rows
    (rows filled to their last byte, bits read past the row, bytes past a
    stream's end, distances 31-33, 64 and 32,768, 15-bit codes)."""
    import importlib

    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    mod = importlib.import_module("libdeflate_rsx_tpu_torch.ops." + name)
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")
    if batch == "edge":
        lens, words = _edge_batch(card)
    else:
        cases = _stream_cases()
        lens, words = v2.pack(cases[10:11] if batch == "one" else cases, card)
    before = mod.LAUNCHES
    out_k = kernel(lens, words)
    assert mod.LAUNCHES == before + 1
    out_p = plain(lens, words)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    empty = kernel(*v2.pack([], card))
    assert empty.shape == (0, v2.OUT_WORDS) and mod.LAUNCHES == before + 1


@pytest.mark.parametrize("name", ["inflate_v2", "inflate_static"])
def test_stream_kernel_writes_every_output_word(card, name):
    """The wrapper's output comes from torch.empty: on memory that held
    other bytes, every row still reads 0 past its count and its trailer
    words (inflate_v2: flags and count; inflate_static: count) are the
    plain version's."""
    import importlib

    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    mod = importlib.import_module("libdeflate_rsx_tpu_torch.ops." + name)
    lens, words = _edge_batch(card)
    want = getattr(mod, name + "_plain")(lens, words)
    torch.cuda.synchronize()
    for _ in range(3):
        junk = torch.full((len(lens), v2.OUT_WORDS), -0x5A5A5A5B,
                          dtype=torch.int32, device=card)
        del junk                          # the caching allocator keeps it
        out = getattr(mod, name)(lens, words)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    cap = (v2.OUT_WORDS - (2 if name == "inflate_v2" else 1)) * 4
    for row in out.cpu().numpy():
        if row[-1] >= 0:
            assert not row.view("<u1")[row[-1]:cap].any()


def test_small_batch_goes_through_inflate_v2_on_card(card):
    from libdeflate_rsx_tpu_torch import BatchDecompressor, Compressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2
    from libdeflate_rsx_tpu_torch.ops import inflate_device_static

    items = [make_corpus(k, 20000, seed=i)
             for i, k in enumerate(("text", "pattern", "random"))]
    for fmt in ("deflate", "zlib", "gzip"):
        comp = [getattr(Compressor(6), "compress_" + fmt)(d) for d in items]
        v2_before, p1_before = v2.LAUNCHES, it.LAUNCHES
        bd = BatchDecompressor(format=fmt, use_device=True, device=card)
        assert bd.decompress_batch(comp, [len(d) for d in items]) == items
        assert not bd.fallbacks
        assert v2.LAUNCHES == v2_before + 1 and it.LAUNCHES == p1_before
    c = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    fixed = c.compress(items[0]) + c.flush()
    assert inflate_device_static([fixed, _z(items[0])], card) == [items[0], None]


TIER_DATAS = [make_corpus("text", 70000, seed=1), make_corpus("pattern", 9000),
              make_corpus("random", 3000, seed=2), b"", b"x"]


@pytest.mark.parametrize("level", range(6))
def test_compress_tiers_on_card_equal_cpu(card, level):
    """The level 0-5 tiers give the same bytes on the card as on the CPU,
    for a batch and for one item alone."""
    from libdeflate_rsx_tpu_torch import BatchCompressor

    gpu = BatchCompressor(level=level, use_device=True,
                          device=card).compress_batch(TIER_DATAS)
    cpu = BatchCompressor(level=level, use_device=True,
                          device="cpu").compress_batch(TIER_DATAS)
    assert gpu == cpu
    assert BatchCompressor(level=level, use_device=True, device=card) \
        .compress_batch(TIER_DATAS[:1]) == cpu[:1]
    assert [zlib.decompress(c, -15) for c in gpu] == TIER_DATAS


@pytest.mark.parametrize("level", [0, 1, 4])
def test_tier_output_decodes_through_the_kernels_on_card(card, level):
    """The tiers' output, decoded on the card by the two-pass decoder (8
    items), the small-batch decoder (3 items) and, for levels 0-1,
    inflate_device_static: byte-exact, no host fallback."""
    from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_device_static
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    datas = [make_corpus(k, 20000 + 4099 * i, seed=i) for i, k in enumerate(
        ("text", "pattern", "zeros", "periodic:7") * 2)]
    comp = BatchCompressor(level=level, use_device=True,
                           device=card).compress_batch(datas)
    caps = [len(d) for d in datas]
    for n, mod in ((8, it), (3, v2)):
        before = mod.LAUNCHES
        bd = BatchDecompressor(use_device=True, resolve="device", device=card)
        assert bd.decompress_batch(comp[:n], caps[:n]) == datas[:n]
        assert not bd.fallbacks and mod.LAUNCHES > before
    if level < 2:
        assert inflate_device_static(comp, card) == datas


def test_checksums_on_card_exact_under_any_matmul_precision(card):
    """The device checksums equal zlib with TF32 and bf16 matmuls
    allowed (the settings are restored afterwards)."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        for size in (1, 127, 1025, 5000, 100001, 1 << 20):
            data = make_corpus("random", size, seed=size)
            assert ck.crc32_device(data, device=card) == zlib.crc32(data)
            assert ck.adler32_device(data, device=card) == zlib.adler32(data)
        a, b = make_corpus("text", 3000), make_corpus("text", 5000, seed=9)
        assert ck.crc32_device(b, zlib.crc32(a), card) == zlib.crc32(a + b)
        assert ck.adler32_device(b, zlib.adler32(a), card) == \
            zlib.adler32(a + b)
        rows = [make_corpus("random", n, seed=n) for n in (0, 1, 1000, 5119,
                                                           5120)]
        data = np.zeros((len(rows), 5120), np.uint8)
        for i, r in enumerate(rows):
            data[i, :len(r)] = np.frombuffer(r, np.uint8)
        args = (torch.from_numpy(data).to(card),
                torch.tensor([len(r) for r in rows], device=card))
        crcs = ck.crc32_blocks(*args).cpu()
        adlers = ck.adler32_blocks(*args).cpu()
        assert crcs.tolist() == [zlib.crc32(r) for r in rows]
        assert adlers.tolist() == [zlib.adler32(r) for r in rows]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("width", CHECKSUM_WIDTHS)
def test_checksum_kernel_equals_plain_on_trap_rows(card, width):
    """crc32_blocks and adler32_blocks launch the kernel and equal the
    plain versions and zlib on the trap rows, with int32 and int64
    lengths; a row view at a wider stride is read in place, one whose
    bytes are not adjacent is copied, with the same results."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    rows, lens = checksum_rows(width)
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    t = torch.from_numpy(rows).to(card)
    wide = torch.zeros((len(rows), width + 48), dtype=torch.uint8,
                       device=card)
    wide[:, 7:7 + width] = t
    views = [t, wide[:, 7:7 + width],
             t.t().contiguous().t()]   # stride (1, B): copied
    assert not views[1].is_contiguous() and views[2].stride(1) != 1
    for n in (torch.from_numpy(lens).to(card),
              torch.from_numpy(lens.astype(np.int32)).to(card)):
        plain_c = ck.crc32_blocks_plain(t, n).cpu().tolist()
        plain_a = ck.adler32_blocks_plain(t, n).cpu().tolist()
        assert plain_c == want_c and plain_a == want_a
        for v in views:
            before = ck.LAUNCHES
            assert ck.crc32_blocks(v, n).cpu().tolist() == want_c
            assert ck.adler32_blocks(v, n).cpu().tolist() == want_a
            assert ck.LAUNCHES == before + 2


def test_checksum_kernel_equals_plain_on_wide_rows(card):
    """Rows wider than the CRC kernel's 64 KiB tile (its register carried
    from tile to tile), read in place and off 16 bytes: equal to the
    plain versions and to zlib."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    rows, lens = checksum_wide_rows()
    want_c = [zlib.crc32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    want_a = [zlib.adler32(r[:n].tobytes()) for r, n in zip(rows, lens)]
    t = torch.from_numpy(rows).to(card)
    n = torch.from_numpy(lens).to(card)
    assert ck.crc32_blocks_plain(t, n).cpu().tolist() == want_c
    assert ck.adler32_blocks_plain(t, n).cpu().tolist() == want_a
    wide = torch.zeros((len(rows), rows.shape[1] + 32), dtype=torch.uint8,
                       device=card)
    wide[:, 5:5 + rows.shape[1]] = t
    for v in (t, wide[:, 5:5 + rows.shape[1]]):
        assert ck.crc32_blocks(v, n).cpu().tolist() == want_c
        assert ck.adler32_blocks(v, n).cpu().tolist() == want_a


def test_checksum_kernel_equals_plain_on_buffers(card):
    """crc32_fixed and adler32_fixed (tiles of 64 KiB, the last one
    short, each in one C call) equal the plain versions and zlib at
    every initial value, both kernels' state left zeroed; crc32_device
    never builds the plain version's host table."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    ck._crc_byte_table.cache_clear()
    for data in checksum_buffers():
        t = ck._padded(data, ck.CRC_CHUNK, card)
        for init in CHECKSUM_INITS:
            before = ck.LAUNCHES
            crc = int(ck.crc32_fixed(t, len(data), init))
            adler = int(ck.adler32_fixed(t, len(data), init))
            assert ck.LAUNCHES == before + 2
            assert crc == zlib.crc32(data, init), (len(data), hex(init))
            assert adler == zlib.adler32(data, init), (len(data), hex(init))
            assert ck.crc32_device(data, init, card) == crc
            assert ck.adler32_device(data, init, card) == adler
    assert ck._crc_byte_table.cache_info().currsize == 0
    assert not any(st.any() for st in ck._STATE.values())
    t = ck._padded(checksum_buffers()[-1], ck.CRC_CHUNK, card)
    for init in CHECKSUM_INITS:
        assert int(ck.crc32_fixed(t, 70000, init)) == \
            int(ck.crc32_fixed_plain(t, 70000, init))
        assert int(ck.adler32_fixed(t, 70000, init)) == \
            int(ck.adler32_fixed_plain(t, 70000, init))
    before = ck.LAUNCHES
    assert int(ck.crc32_fixed(t, 0, 5)) == 5
    assert int(ck.adler32_fixed(t, 0, 7)) == 7
    assert ck.crc32_device(b"", 9, card) == 9
    assert ck.LAUNCHES == before


def _adler_kernels(fn) -> list[str]:
    """The names of the CUDA kernels one call of fn launches
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if "kernel" in e.key]


def test_adler_kernel_one_launch_state_and_streams(card):
    """adler32_fixed on a buffer is one C call and one kernel launch
    (adler_kernel, torch.profiler); two calls in a row, and calls on two
    streams, give zlib's value and leave every state zeroed; a batch of
    rows wider than a tile gives the same results after a narrow batch
    as alone, and a narrow batch allocates no state."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    data = checksum_buffers()[0]                     # 1 MiB + 3 bytes
    t = ck._padded(data, ck.CRC_CHUNK, card)
    for init in (1, 0xFFF0FFF0):
        before = ck.LAUNCHES
        got = [int(ck.adler32_fixed(t, len(data), init)) for _ in range(2)]
        assert ck.LAUNCHES == before + 2
        assert got == [zlib.adler32(data, init)] * 2
    names = _adler_kernels(lambda: ck.adler32_fixed(t, len(data), 1))
    assert len(names) == 1 and "adler_kernel" in names[0], names
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    outs = []
    for _ in range(3):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ck.adler32_fixed(t, len(data), 7))
    torch.cuda.synchronize()
    assert [int(o) for o in outs] == [zlib.adler32(data, 7)] * 6
    assert not any(st.any() for st in ck._STATE.values())
    wide, lens = checksum_wide_rows()
    w, n = torch.from_numpy(wide).to(card), torch.from_numpy(lens).to(card)
    want = [zlib.adler32(r[:k].tobytes()) for r, k in zip(wide, lens)]
    assert ck.adler32_blocks(w, n).cpu().tolist() == want
    keys = set(ck._STATE)
    narrow, nl = checksum_rows(5120)
    assert ck.adler32_blocks(torch.from_numpy(narrow).to(card),
                             torch.from_numpy(nl).to(card)).cpu().tolist() \
        == [zlib.adler32(r[:k].tobytes()) for r, k in zip(narrow, nl)]
    assert set(ck._STATE) == keys
    assert ck.adler32_blocks(w, n).cpu().tolist() == want
    assert not any(st.any() for st in ck._STATE.values())


@pytest.mark.parametrize("case", ["ff", "odd_stride", "items"])
def test_adler_kernel_equals_plain_on_new_traps(card, case):
    """The Adler traps of the tile design on the card, each with the CRC
    beside it: all-0xFF rows of one, two and three tiles (the 32-bit
    bound); rows at an odd stride (single-byte loads) with random bytes
    past each length, the plain versions on the zero-padded rows; 17
    rows of 1 MiB (the compress items' shape, tiles spread over the
    blocks), the last one short. Kernel, plain version and zlib equal."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    if case == "ff":
        rows, lens = checksum_ff_rows()
        view = torch.from_numpy(rows).to(card)
    elif case == "odd_stride":
        store, lens = checksum_odd_stride()
        rows = np.where(np.arange(store.shape[1] - 1) < lens[:, None],
                        store[:, :-1], 0).astype(np.uint8)
        view = torch.from_numpy(store).to(card)[:, :-1]
        assert view.stride(0) % 2 == 1
    else:
        data = make_corpus("text", 17 << 20, seed=5)[:(17 << 20) - 1234]
        rows = np.zeros((17, 1 << 20), np.uint8)
        rows.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
        lens = np.array([1 << 20] * 16 + [(1 << 20) - 1234], np.int64)
        view = torch.from_numpy(rows).to(card)
    n = torch.from_numpy(lens).to(card)
    zeroed = torch.from_numpy(rows).to(card)
    for kernel, plain, ref in ((ck.adler32_blocks, ck.adler32_blocks_plain,
                                zlib.adler32),
                               (ck.crc32_blocks, ck.crc32_blocks_plain,
                                zlib.crc32)):
        want = [ref(r[:k].tobytes()) for r, k in zip(rows, lens)]
        before = ck.LAUNCHES
        assert kernel(view, n).cpu().tolist() == want
        assert ck.LAUNCHES == before + 1
        assert plain(zeroed, n).cpu().tolist() == want
    assert not any(st.any() for st in ck._STATE.values())


def test_checksum_kernel_guards(card):
    """A wrong dtype, shape, width or lengths raises before any launch;
    an empty batch launches nothing."""
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    n = torch.tensor([3], device=card)
    before = ck.LAUNCHES
    for fn in (ck.crc32_blocks, ck.adler32_blocks):
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 1024), dtype=torch.int32, device=card), n)
        with pytest.raises(ValueError):
            fn(torch.zeros(1024, dtype=torch.uint8, device=card), n)
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 1000), dtype=torch.uint8, device=card), n)
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 1024), dtype=torch.uint8, device=card),
               n.cpu())
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 1024), dtype=torch.uint8, device=card), n)
        assert fn(torch.zeros((0, 1024), dtype=torch.uint8, device=card),
                  torch.zeros(0, dtype=torch.int32, device=card)).shape == (0,)
    for fn in (ck.crc32_fixed, ck.adler32_fixed):
        with pytest.raises(ValueError):
            fn(torch.zeros(1024, dtype=torch.int8, device=card), 3)
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 1024), dtype=torch.uint8, device=card), 3)
        with pytest.raises(ValueError):
            fn(torch.zeros(1024, dtype=torch.uint8, device=card), 1025)
    assert ck.LAUNCHES == before


def test_sharded_static_gzip_launches_the_checksum_kernel(card, tmp_path):
    """ShardedCompressor(tier="static") at NCCL world size 1: zlib and
    gzip each launch the checksum kernel twice a pass and round-trip;
    deflate launches nothing. The block rows' strided numpy view arrives
    on the card contiguous."""
    import gzip

    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from libdeflate_rsx_tpu_torch.parallel import (ShardedCompressor,
                                                   multihost)

    padded = np.zeros((3, 65536 + 264), np.uint8)
    assert torch.from_numpy(padded[1:3, :65536]).to(card).is_contiguous()
    multihost.initialize(multihost.file_rendezvous(str(tmp_path)), 1, 0,
                         backend="nccl")
    data = make_corpus("text", 300000, seed=3)
    sc = ShardedCompressor(device=card)
    before = ck.LAUNCHES
    sc.compress(data, "deflate")
    assert ck.LAUNCHES == before
    assert zlib.decompress(sc.compress(data, "zlib")) == data
    assert gzip.decompress(sc.compress(data, "gzip")) == data
    assert ck.LAUNCHES == before + 4


def _histograms(n: int, seed: int):
    """Block-like and tie-heavy (ll (n, 288), of (n, 30)) histograms,
    and edge cases: an empty block, one literal, all 288 symbols, counts
    saturated at 65,535, geometric counts past the 14-bit limit."""
    rng = np.random.default_rng(seed)
    ll = np.zeros((n, 288), np.int64)
    of = np.zeros((n, 30), np.int64)
    ll[0::2, :256] = rng.geometric(0.02, (len(ll[0::2]), 256))
    ll[0::2, 257:286] = rng.geometric(0.05, (len(ll[0::2]), 29))
    of[0::2] = rng.geometric(0.1, (len(of[0::2]), 30))
    ll[1::2, :286] = rng.integers(0, 3, (len(ll[1::2]), 286))
    of[1::2] = rng.integers(0, 2, (len(of[1::2]), 30))
    ll[0], of[0] = 0, 0
    ll[1], of[1] = 0, 0
    ll[1, 65] = 7
    ll[2], of[2] = 1, 1
    ll[3], of[3] = 65535, 65535
    fib = [1, 1]
    while len(fib) < 288:
        fib.append(min(fib[-1] + fib[-2], 65535))
    ll[4], of[4] = fib, fib[:30]
    return (np.minimum(ll, 65535).astype(np.uint16),
            np.minimum(of, 65535).astype(np.uint16))


def test_dyn_tables_kernel_equals_plain_on_card(card):
    """The table kernel's four outputs equal the Python builder's on
    edge, block-like and tie-heavy histograms; the launch is counted."""
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dt

    ll, of = (torch.from_numpy(x.astype(np.int32)).to(torch.uint16).to(card)
              for x in _histograms(300, seed=3))
    finals = torch.arange(300, device=card) % 2 == 0
    before = dt.LAUNCHES
    got = dt.build_tables(ll, of, finals)
    assert dt.LAUNCHES == before + 1
    want = dt.build_tables_plain(ll, of, finals)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)


def _tier_rows(tier: str, data: bytes, card, block: int = 16384):
    """assemble's inputs for one tier's pass on the card, from the
    flow's own helper."""
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs

    if tier == "static":
        arr, valid, finals, _ = gs.split_blocks(data, block)
        return gs.static_pass(arr, valid, finals, block, card)
    if tier == "l4":
        arr, valid, finals, _ = gs.split_blocks(data, block)
        return gd.dynamic_pass(arr, valid, finals, block, card)[0]
    arr, valid, hist, finals, _ = gd.split_blocks_hist(data, block)
    return gd.dynamic_pass(arr, valid, finals, block, card, hist)[0]


def _assemble_equals_plain(inputs):
    """assemble on the card (one launch) against place_rows_plain then
    join_rows_plain on the same card tensors. Returns the joined bytes'
    parts."""
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    before = asm.LAUNCHES
    joined_k, sizes_k = asm.assemble(*inputs)
    assert asm.LAUNCHES == before + 1
    joined_p, sizes_p = asm.join_rows_plain(
        *asm.place_rows_plain(*inputs[:8], inputs.out_cap), inputs.raw,
        inputs.raw_len, inputs.finals)
    torch.cuda.synchronize()
    assert (sizes_k == sizes_p).all() and torch.equal(joined_k, joined_p)
    return asm.split_parts(joined_k, sizes_k)


@pytest.mark.parametrize("tier", ["static", "l4", "l6"])
def test_assembly_kernels_equal_plain_on_card(card, tier):
    """The assembly kernel on the card equals its plain versions (on the
    same card tensors): place_rows' every stream byte and byte count,
    join_rows' and assemble's joined bytes with a random block stored;
    one launch for each call; a block past out_cap raises."""
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    data = (make_corpus("text", 16384, seed=1)
            + make_corpus("random", 16384, seed=2)
            + make_corpus("pattern", 30000, seed=3))
    inputs = _tier_rows(tier, data, card)
    place, (raw, raw_len, out_cap) = inputs[:8], inputs[8:]
    finals = inputs.finals
    before = asm.LAUNCHES
    out_k, nb_k = asm.place_rows(*place, out_cap)
    out_p, nb_p = asm.place_rows_plain(*place, out_cap)
    torch.cuda.synchronize()
    assert torch.equal(nb_k, nb_p)
    assert torch.equal(out_k[:, :out_cap], out_p)
    joined_k, sizes_k = asm.join_rows(out_k, nb_k, raw, raw_len, finals)
    joined_p, sizes_p = asm.join_rows_plain(out_p, nb_p, raw, raw_len,
                                            finals)
    assert asm.LAUNCHES == before + 2
    assert (sizes_k == sizes_p).all() and torch.equal(joined_k, joined_p)
    parts = asm.split_parts(joined_k, sizes_k)
    assert parts[1][0] in (0, 1) and len(parts[1]) == 16384 + 5
    assert zlib.decompress(b"".join(parts), -15) == data
    assert _assemble_equals_plain(inputs) == parts
    small = int(nb_p[0]) - 1
    assert int(asm.place_rows(*place, small)[1][0]) == -1
    with pytest.raises(ValueError, match="output capacity"):
        asm.assemble(*place, raw, raw_len, small)


def test_assembly_kernel_empty_batch_on_card(card):
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    before = asm.LAUNCHES
    rows = torch.zeros((0, 4, 49), dtype=torch.uint8, device=card)
    offs = torch.zeros((0, 4), dtype=torch.int64, device=card)
    ends = torch.zeros(0, dtype=torch.int64, device=card)
    hdr = torch.zeros((0, 1), dtype=torch.uint8, device=card)
    ints = torch.zeros(0, dtype=torch.int32, device=card)
    finals = torch.zeros(0, dtype=torch.bool, device=card)
    raw = torch.zeros((0, 8), dtype=torch.uint8, device=card)
    out, nbytes = asm.place_rows(rows, offs, offs, ends, hdr, ints, ints,
                                 finals, 64)
    assert out.shape == (0, 64) and nbytes.shape == (0,)
    joined, sizes = asm.join_rows(out, nbytes, raw, ends, finals)
    assert joined.shape == (0,) and sizes.shape == (0,)
    joined, sizes = asm.assemble(rows, offs, offs, ends, hdr, ints, ints,
                                 finals, raw, ends, 64)
    assert joined.shape == (0,) and sizes.shape == (0,)
    assert asm.LAUNCHES == before


@pytest.mark.parametrize("tier", ["static", "l4"])
def test_assembly_kernel_global_scratch_route_on_card(card, tier):
    """Blocks of 256 KiB: their streams pass the shared-memory limit, so
    the kernel builds them in global rows (place_rows in its output,
    assemble in a scratch buffer); equal to the plain versions, with the
    random block stored."""
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    block = 1 << 18
    data = (make_corpus("text", block, seed=1)
            + make_corpus("random", block, seed=2)
            + make_corpus("pattern", 70000, seed=3))
    inputs = _tier_rows(tier, data, card, block)
    limit = asm.smem_limit(card)
    assert -(-inputs.out_cap // 4) * 4 > limit
    assert min(inputs.out_cap, asm.stored_cost(inputs.raw.shape[1])) > limit
    out_k, nb_k = asm.place_rows(*inputs[:8], inputs.out_cap)
    out_p, nb_p = asm.place_rows_plain(*inputs[:8], inputs.out_cap)
    torch.cuda.synchronize()
    assert torch.equal(nb_k, nb_p)
    assert torch.equal(out_k[:, :inputs.out_cap], out_p)
    parts = _assemble_equals_plain(inputs)
    assert len(parts[1]) == block + 5 * 5
    assert zlib.decompress(b"".join(parts), -15) == data


@pytest.mark.parametrize("level", [1, 4, 6])
def test_device_tiers_finish_blocks_through_the_kernels(card, level,
                                                        monkeypatch):
    """BatchCompressor at levels 1, 4 and 6 on the card: the CPU's bytes,
    with one assembly launch a pass and, at levels 4 and 6, one table
    launch a pass, at level 6 one match_l6 launch a pass, at levels 1 and
    4 one match_v2 launch a pass, and one select
    and one emit launch a pass at every level; what the flow copies off the card is
    the joined streams (1-D uint8) and the blocks' byte counts and sizes
    ((2, B) int64), no histogram, table or row buffer."""
    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops import assemble as asm
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dt
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops import emit as em
    from libdeflate_rsx_tpu_torch.ops import select as sl

    phases = []
    monkeypatch.setattr(gs, "PHASE_END", phases.append)
    copied = []
    for name in ("cpu", "numpy", "tolist", "item"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, **k):
            if self.is_cuda:
                copied.append((tuple(self.shape), self.dtype))
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    tables, places, matches = dt.LAUNCHES, asm.LAUNCHES, ml6.LAUNCHES
    selects, emits, v2s = sl.LAUNCHES, em.LAUNCHES, mv2.LAUNCHES
    gpu = BatchCompressor(level=level, use_device=True,
                          device=card).compress_batch(TIER_DATAS)
    monkeypatch.undo()
    assert copied and all(
        (dtype == torch.uint8 and len(shape) == 1)
        or (dtype == torch.int64 and len(shape) == 2 and shape[0] == 2)
        for shape, dtype in copied), copied
    passes = phases.count("assemble")
    assert passes >= 1 and asm.LAUNCHES == places + passes
    assert dt.LAUNCHES == tables + (passes if level >= 4 else 0)
    assert ml6.LAUNCHES == matches + (passes if level >= 6 else 0)
    assert mv2.LAUNCHES == v2s + (passes if level < 6 else 0)
    assert sl.LAUNCHES == selects + passes
    assert em.LAUNCHES == emits + passes
    assert phases.count("tables") == (passes if level >= 4 else 0)
    cpu = BatchCompressor(level=level, use_device=True,
                          device="cpu").compress_batch(TIER_DATAS)
    assert gpu == cpu
    assert [zlib.decompress(c, -15) for c in gpu] == TIER_DATAS


def _resolve_equal(tokens, out_cap, counts=None):
    """The resolve kernel against its plain version on the same columns
    (and token counts): outlen and ok equal, and the bytes [0, outlen)
    of every ok row."""
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    before = rs.LAUNCHES
    out, outlen, ok = rs.resolve_batch(tokens, out_cap, counts)
    assert rs.LAUNCHES == before + (tokens.shape[0] > 0)
    pout, plen, pok = rs.resolve_batch_plain(tokens, out_cap, counts)
    torch.cuda.synchronize()
    assert out.shape == pout.shape == (tokens.shape[0], out_cap)
    assert torch.equal(outlen, plen) and torch.equal(ok, pok)
    for i in ok.nonzero().flatten().tolist():
        n = int(outlen[i])
        assert torch.equal(out[i, :n], pout[i, :n]), i
    return ok


@pytest.mark.parametrize("case", list(RESOLVE_CASES))
def test_resolve_kernel_equals_plain_on_card(card, case):
    cols, out_cap = RESOLVE_CASES[case]()
    _resolve_equal(torch.from_numpy(np.stack(cols)).to(card), out_cap)


@pytest.mark.parametrize("out_cap", [65536, 1 << 20])
def test_resolve_kernel_on_pass1_tokens(card, out_cap):
    """Pass 1's tokens as the decoder hands them over (a strided view of
    its buffer, with and without its token counts), every well-formed
    stream resolved to its bytes; counts that cut the columns short; T
    == 0 and B == 0."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch

    datas = [make_corpus(k, 40000 + 999 * i, seed=i)
             for i, k in enumerate(("text", "pattern", "random", "zeros",
                                    "periodic:7", "text"))]
    streams = [_z(d, lvl) for d, lvl in zip(datas, (6, 9, 1, 6, 6, 0))]
    streams += [_z(b"\x5a" * (1 << 20))]
    args = it.pack_streams(streams, it.in_cap_bucket(streams), card)[:3]
    tok, st = it.pass1(*args, out_cap)
    ntok = int(st[:, 3].max())
    counts = st[:, 3].contiguous()
    ok = _resolve_equal(tok[:, :ntok], out_cap)
    assert torch.equal(ok, _resolve_equal(tok[:, :ntok], out_cap, counts))
    out, outlen, _ = resolve_batch(tok[:, :ntok], out_cap, counts)
    for i, d in enumerate(datas + [b"\x5a" * (1 << 20)]):
        if len(d) <= out_cap:
            assert bool(ok[i]) and out[i, :len(d)].cpu().numpy().tobytes() \
                == d
    _resolve_equal(tok[:, :ntok], out_cap, counts // 3)
    for shape in ((3, 0), (0, 5)):
        tok0 = torch.zeros(shape, dtype=torch.int32, device=card)
        _resolve_equal(tok0, out_cap)
        _resolve_equal(tok0, out_cap, torch.zeros(shape[0], dtype=torch.int32,
                                                  device=card))


def test_two_pass_decode_goes_through_the_resolve_kernel(card):
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    datas = [make_corpus(("text", "pattern", "random", "periodic:7")[i % 4],
                         20000 + 4099 * i, seed=i) for i in range(10)]
    streams = [zlib.compress(d, 6) for d in datas]
    before, pass1 = rs.LAUNCHES, it.LAUNCHES
    bd = BatchDecompressor("zlib", use_device=True, resolve="device",
                           device=card)
    assert bd.decompress_batch(streams, [len(d) for d in datas]) == datas
    assert not bd.fallbacks
    assert rs.LAUNCHES > before and it.LAUNCHES > pass1


def _match_equal(rows, valid, hist, s):
    """The match kernel (one launch) against its plain version on the
    same card tensors: ml and dist equal, int64 (B, s)."""
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import \
        find_matches_l6_plain

    before = ml6.LAUNCHES
    got = ml6.find_matches_l6(rows, valid, hist, s)
    assert ml6.LAUNCHES == before + (rows.shape[0] > 0)
    want = find_matches_l6_plain(rows, valid, hist, s)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int64
        assert g.shape == (rows.shape[0], s) and torch.equal(g, w)


def test_match_l6_kernel_equals_plain_on_trap_windows(card):
    """The trap windows of the CPU tests (tests/test_torch_match_l6.py):
    the rank rule, hist_start, distances 32,767-32,769, the tail and
    padding, ties, the decay, a first and a short block."""
    _, rows, valid, hist, s = l6_windows()
    _match_equal(*(torch.from_numpy(x).to(card) for x in (rows, valid,
                                                          hist)), s)


@pytest.mark.parametrize("block", [16384, 65536])
@pytest.mark.parametrize("kind", ["text", "random", "zeros", "pattern",
                                  "periodic:7"])
def test_match_l6_kernel_equals_plain_on_flow_rows(card, kind, block):
    """The encode flow's own rows (history prefixes, a first block with
    hist_start = HIST, a short last block) at both block sizes."""
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd

    data = make_corpus(kind, 3 * block + 777, seed=len(kind))
    arr, valid, hist, _, _ = gd.split_blocks_hist(data, block)
    _match_equal(*(torch.from_numpy(x).to(card) for x in (arr, valid, hist)),
                 gd.HIST + block)


def test_match_l6_kernel_more_windows_than_sms(card):
    """More windows than the card has SMs, and so than it holds clusters
    at once: each persistent cluster takes several windows in turn."""
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6

    _, rows, valid, hist, s = l6_windows()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert ml6.launch_shape(s, card)[2] < sms
    reps = -(-(sms + 5) // rows.shape[0])
    rows = np.concatenate([np.roll(rows, 7 * k, axis=1) for k in range(reps)])
    _match_equal(torch.from_numpy(rows).to(card),
                 torch.from_numpy(np.tile(valid, reps)).to(card),
                 torch.from_numpy(np.tile(hist, reps)).to(card), s)


def test_match_l6_kernel_launch_shape(card):
    """The main path's windows (64 KiB blocks) take clusters of 8 blocks,
    the largest blocks the L6 tier takes (98,000 bytes) clusters of 16,
    and the card holds at least one cluster of either."""
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6

    size, smem, clusters = ml6.launch_shape(32768 + 65536, card)
    assert size == 8 and 0 < smem <= 232448 and clusters >= 1
    size, smem, clusters = ml6.launch_shape(32768 + 98000, card)
    assert size == 16 and 0 < smem <= 232448 and clusters >= 1


def test_match_l6_kernel_equals_plain_on_the_largest_windows(card):
    """Windows of the largest L6 block (98,000 bytes), which take clusters
    of 16 blocks: the trap windows at that width."""
    _, rows, valid, hist, s = l6_windows(block=98000)
    _match_equal(*(torch.from_numpy(x).to(card) for x in (rows, valid,
                                                          hist)), s)


def test_match_l6_kernel_empty_batch_and_guards(card):
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6

    s = 49152
    rows = torch.zeros((0, s + 266), dtype=torch.uint8, device=card)
    none = torch.zeros(0, dtype=torch.int32, device=card)
    _match_equal(rows, none, none, s)
    one = torch.zeros(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        ml6.find_matches_l6(rows[:0], none, none, (1 << 17) - 258)
    with pytest.raises(ValueError):
        ml6.find_matches_l6(torch.zeros((1, s + 266), dtype=torch.uint8,
                                        device=card), one, one, s,
                            levels=(16, 32))
    with pytest.raises(ValueError):
        ml6.find_matches_l6(torch.zeros((1, s + 8), dtype=torch.uint8,
                                        device=card), one, one, s)


# ---------------------------------------------------- L1-5 match finder
def _v2_equal(rows, valid, s) -> int:
    """The L1-5 match kernel (one launch) against its plain version on the
    same card tensors: ml and dist equal, int64 (B, s). Returns the
    windows of the launch that took the sort by the whole word."""
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import (find_matches_v2,
                                                        find_matches_v2_plain)

    before = mv2.LAUNCHES
    if rows.shape[0]:
        mv2.reset_escapes(rows.device)
    got = find_matches_v2(rows, valid, s)
    assert mv2.LAUNCHES == before + (rows.shape[0] > 0)
    want = find_matches_v2_plain(rows, valid, s)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.int64
        assert g.shape == (rows.shape[0], s) and torch.equal(g, w)
    return mv2.escapes(rows.device) if rows.shape[0] else 0


def _v2_escaping(labels) -> int:
    return sum("(escape)" in x for x in labels)


@pytest.mark.parametrize("s", V2_SIZES)
def test_match_v2_kernel_equals_plain_on_trap_blocks(card, s):
    """The trap blocks of the CPU tests (tests/test_torch_match_v2.py):
    the dist kept past the cap, non-zero padding, the first sorted
    element, one repeated byte, distances 32,767-32,769, valid_len 0-8,
    a short last block, w1 in byte 0-3, sizes off the cluster's chunk,
    the windows of a block past 65,536, the collision traps of the sort
    by hash. Only the escape traps' windows take the sort by the whole
    word (two windows each past 65,536)."""
    labels, rows, valid = v2_cases(s)
    esc = _v2_equal(torch.from_numpy(rows).to(card),
                    torch.from_numpy(valid).to(card), s)
    assert esc == _v2_escaping(labels) * (2 if s > 65536 else 1)


@pytest.mark.parametrize("s", V2_SIZES)
def test_match_v2_kernel_equals_plain_on_trap_blocks_in_8_block_clusters(
        card, s):
    """The same trap blocks in batches small enough for one round of
    8-block clusters, the shape an L1 pass of few blocks takes."""
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2

    labels, rows, valid = v2_cases(s)
    per_row = len(mv2.windows(s))
    size, _, clusters, _ = mv2.launch_shape(s, 1, card)
    assert size == 8
    step = max(1, clusters // per_row)
    esc = 0
    for i in range(0, len(labels), step):
        assert mv2.launch_shape(s, len(labels[i:i + step]), card)[0] == 8
        esc += _v2_equal(torch.from_numpy(rows[i:i + step]).to(card),
                         torch.from_numpy(valid[i:i + step]).to(card), s)
    assert esc == _v2_escaping(labels) * (2 if s > 65536 else 1)


@pytest.mark.parametrize("s", [1021, 65536, 100000])
def test_match_v2_kernel_equals_plain_on_trap_blocks_in_6_block_clusters(
        card, s):
    """The trap blocks in batches of one window more than the resident
    8-block clusters hold (an L1 pass of 16 blocks on an H100): the
    launch takes 6-block clusters in one round."""
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2

    labels, rows, valid = v2_cases(s)
    per_row = len(mv2.windows(s))
    step = mv2.launch_shape(s, 1, card)[2] // per_row + 1
    size, _, clusters, rounds = mv2.launch_shape(s, step, card)
    assert size == 6 and rounds == 1
    # every block in a batch of `step`, the last batch ending at the end
    starts = sorted(set(range(0, len(labels) - step, step))
                    | {len(labels) - step})
    esc = want = 0
    for i in starts:
        esc += _v2_equal(torch.from_numpy(rows[i:i + step]).to(card),
                         torch.from_numpy(valid[i:i + step]).to(card), s)
        want += _v2_escaping(labels[i:i + step]) * (2 if s > 65536 else 1)
    assert esc == want and want > 0


@pytest.mark.parametrize("block", [16384, 65536, 262144])
@pytest.mark.parametrize("kind", ["text", "random", "zeros", "pattern",
                                  "periodic:7"])
def test_match_v2_kernel_equals_plain_on_flow_rows(card, kind, block):
    """The L1-5 tiers' own rows (a short last block) at the sharded
    helpers', the tiers' and the global-scratch tests' block sizes."""
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs

    data = make_corpus(kind, 3 * block + 777, seed=len(kind))
    arr, valid, _, _ = gs.split_blocks(data, block)
    assert _v2_equal(torch.from_numpy(arr).to(card),
                     torch.from_numpy(valid).to(card).long(), block) == 0


def test_match_v2_kernel_more_windows_than_clusters(card):
    """More blocks than the card holds clusters at once: each persistent
    cluster takes several windows in turn."""
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2

    s = 65536
    labels, rows, valid = v2_cases(s)
    clusters = mv2.launch_shape(s, rows.shape[0], card)[2]
    reps = -(-(clusters + 5) // rows.shape[0])
    rows = np.concatenate([np.roll(rows, 7 * k, axis=1) for k in range(reps)])
    size, smem, clusters, rounds = mv2.launch_shape(s, rows.shape[0], card)
    assert size == 4 and 0 < smem <= 232448 and clusters >= 1 and rounds >= 2
    esc = _v2_equal(torch.from_numpy(rows).to(card),
                    torch.from_numpy(np.tile(valid, reps)).to(card), s)
    assert esc >= _v2_escaping(labels)


def test_match_v2_kernel_empty_batch_and_guards(card):
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import find_matches_v2

    s = 65536
    none = torch.zeros(0, dtype=torch.int32, device=card)
    _v2_equal(torch.zeros((0, s + 266), dtype=torch.uint8, device=card),
              none, s)
    one = torch.full((1,), s, dtype=torch.int32, device=card)
    before = mv2.LAUNCHES
    with pytest.raises(ValueError):                 # no room past the block
        find_matches_v2(torch.zeros((1, s + 8), dtype=torch.uint8,
                                    device=card), one, s)
    with pytest.raises(ValueError):
        find_matches_v2(torch.zeros((1, s + 266), dtype=torch.int32,
                                    device=card), one, s)
    with pytest.raises(ValueError):
        find_matches_v2(torch.zeros((1, 300), dtype=torch.uint8,
                                    device=card), one, 0)
    assert mv2.LAUNCHES == before


# ------------------------------------------------------------ selection
SELECT_FLAGS = {"l6": (True, True), "dynamic": (False, True),
                "static": (False, False)}


def _select_equal(ml, dist, valid, data, l6):
    """The select kernel (one launch) against its plain version on the
    same card tensors: every output equal, of the plain version's dtypes
    and shapes, dist a slice of its input. data None: no histograms."""
    from libdeflate_rsx_tpu_torch.ops import select as sl

    before = sl.LAUNCHES
    got = sl.select(ml, dist, valid, data, l6=l6)
    assert sl.LAUNCHES == before + (ml.shape[0] > 0)
    want = sl.select_plain(ml, dist, valid, data, l6=l6)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (4 if data is None else 6)
    assert got[1].data_ptr() == want[1].data_ptr()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(g, w)
    return got


def test_select_kernel_equals_plain_on_trap_windows(card):
    """The L6 trap windows (tests/test_torch_select.py), through the
    match kernel first, as analyze_block_l6 runs them."""
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6

    _, rows, valid, hist, s = l6_windows()
    rows, valid, hist = (torch.from_numpy(x).to(card)
                         for x in (rows, valid, hist))
    ml, dist = ml6.find_matches_l6(rows, valid, hist, s)
    _select_equal(ml, dist, valid.long(), rows, True)


@pytest.mark.parametrize("flags", list(SELECT_FLAGS))
def test_select_kernel_equals_plain_on_edge_arrays(card, flags):
    """The seeded edge arrays of tests/_port_corpus.select_cases at each
    caller's flags (cells of 256 and 64)."""
    _, ml, dist, valid, data = select_cases()
    l6, hist = SELECT_FLAGS[flags]
    _select_equal(*(torch.from_numpy(x).to(card) for x in (ml, dist, valid)),
                  torch.from_numpy(data).to(card) if hist else None, l6)


@pytest.mark.parametrize("flags", list(SELECT_FLAGS))
def test_select_kernel_equals_plain_on_tile_edge_arrays(card, flags):
    """The tile-edge arrays of tests/_port_corpus.select_tile_cases
    (chains, runs, long matches, valid_len and lazy-demotion pairs at the
    kernel's tile edges and halo ends) at each caller's flags."""
    l6, hist = SELECT_FLAGS[flags]
    _, ml, dist, valid, data = select_tile_cases(32768 if l6 else 0)
    _select_equal(*(torch.from_numpy(x).to(card) for x in (ml, dist, valid)),
                  torch.from_numpy(data).to(card) if hist else None, l6)


def test_select_kernel_equals_plain_on_the_largest_windows(card):
    """The L6 tier's largest windows whose payload the 256-position cells
    divide (97,792-byte blocks; the match finder admits up to 98,045),
    and a 65,536-byte payload of one literal byte, whose bin saturates."""
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6

    _, rows, valid, hist, s = l6_windows(block=97792)
    rows, valid, hist = (torch.from_numpy(x).to(card)
                         for x in (rows, valid, hist))
    ml, dist = ml6.find_matches_l6(rows, valid, hist, s)
    _select_equal(ml, dist, valid.long(), rows, True)
    s = 32768 + 65536
    zero = torch.zeros((1, s), dtype=torch.int64, device=card)
    got = _select_equal(zero, zero, torch.full((1,), s, device=card),
                        torch.full((1, s + 266), 7, dtype=torch.uint8,
                                   device=card), True)
    assert int(got[4][0, 7]) == 65535


@pytest.mark.parametrize("block", [16384, 65536, 262144])
@pytest.mark.parametrize("kind", ["text", "random", "zeros", "periodic:7"])
def test_select_kernel_equals_plain_on_flow_rows(card, kind, block):
    """The L1-5 tiers' rows (find_matches_v2 on the flow's blocks, a short
    last block) at their flags, up to 256 KiB blocks."""
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import find_matches_v2

    data = make_corpus(kind, 2 * block + 777, seed=len(kind))
    arr, valid, _, _ = gs.split_blocks(data, block)
    arr, valid = torch.from_numpy(arr).to(card), \
        torch.from_numpy(valid).to(card).long()
    ml, dist = find_matches_v2(arr, valid, block)
    for name in ("dynamic", "static"):
        _select_equal(ml, dist, valid, arr if name == "dynamic" else None,
                      False)


def test_select_kernel_empty_batch_and_guards(card):
    from libdeflate_rsx_tpu_torch.ops import select as sl

    s = 32768 + 16384
    none = torch.zeros((0, s), dtype=torch.int64, device=card)
    got = _select_equal(none, none, torch.zeros(0, dtype=torch.int64,
                                                device=card),
                        torch.zeros((0, s + 266), dtype=torch.uint8,
                                    device=card), True)
    assert got[0].shape == (0, 16384) and got[4].shape == (0, 288)
    one = torch.zeros((1, s), dtype=torch.int64, device=card)
    valid = torch.full((1,), s, device=card)
    rows = torch.zeros((1, s + 266), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError):                  # cells of 256
        sl.select(one[:, :s - 64], one[:, :s - 64], valid, rows, l6=True)
    with pytest.raises(ValueError):                  # short of HIST
        sl.select(one[:, :1024], one[:, :1024], valid, rows, l6=True)
    with pytest.raises(ValueError):
        sl.select(one.int(), one, valid, rows, l6=True)
    with pytest.raises(ValueError):
        sl.select(one, one, valid, rows[:, :s - 1], l6=True)


def _emit_equal(data, ml, dist, sel, lit, s, *tables):
    """The emit kernel (one launch) against its plain version on the same
    card tensors: every output equal, every padding byte of the rows
    included. tables: (ll_tab, of_tab, start_bits) for the dynamic mode,
    none for the static one."""
    from libdeflate_rsx_tpu_torch.ops import emit as em

    before = em.LAUNCHES
    got = em.emit(data, ml, dist, sel, lit, s, *tables)
    assert em.LAUNCHES == before + (ml.shape[0] > 0)
    want = em.emit_plain(data, ml, dist, sel, lit, s, *tables)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert g.shape == w.shape and torch.equal(g, w)
    return got


def _emit_arrays(case, card):
    """A case of tests/_port_corpus.emit_cases or emit_random_cases on the
    card: (data, ml, dist, sel, lit, s) and (ll_tab, of_tab, start_bits)."""
    _, data, ml, dist, sel, lit, ll, of, start = case
    lanes = tuple(torch.from_numpy(x).to(card)
                  for x in (data, ml, dist, sel, lit))
    return (*lanes, ml.shape[1]), tuple(torch.from_numpy(x).to(card)
                                        for x in (ll, of, start))


@pytest.mark.parametrize("make", [emit_cases, emit_random_cases])
def test_emit_kernel_equals_plain_on_edge_and_overflowing_rows(card, make):
    """The seeded trap arrays (matches on a row's, a tile's and the
    block's last lane, rows filled to their frame, the longest lengths
    and distances, inactive lanes, no tokens, blocks starting at bits
    0..65,538) and random rows that overflow their frames, in both
    modes; and again through column slices of wider rows, as the L6 flow
    hands its bytes and distances over (the kernel reads every row
    stride and alignment in place)."""
    lanes, tables = _emit_arrays(make(), card)
    _emit_equal(*lanes, *tables)
    _emit_equal(*lanes)
    data, ml, dist, sel, lit, s = lanes
    for pad in (40, 41):         # (ml, dist) rows on 16 bytes, and not
        wide = [torch.cat([torch.zeros_like(x[:, :pad]), x], dim=1)[:, pad:]
                for x in (data, ml, dist, sel, lit)]
        assert wide[2].stride(0) == s + pad
        _emit_equal(*wide, s, *tables)
        _emit_equal(*wide, s)


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("make", [emit_cases, emit_random_cases,
                                  emit_chunk_cases])
def test_emit_kernel_tile_edges_and_unaligned_rows(card, make, unaligned):
    """The trap, overflowing and tile-edge arrays, as they are and
    through emit_unaligned (every array's rows off 16 bytes), in both
    modes."""
    lanes, tables = _emit_arrays(make(), card)
    if unaligned:
        lanes = (*emit_unaligned(*lanes[:5]), lanes[5])
    _emit_equal(*lanes, *tables)
    _emit_equal(*lanes)


def test_emit_kernel_state_and_launch_shape(card):
    """The kernel's state is left zeroed: calls on the current stream and
    on a side stream, one after another and in turns, give equal outputs;
    the launch takes tiles of 2,048 lanes with no more blocks than are
    resident at once or than half the tiles."""
    from libdeflate_rsx_tpu_torch.ops import emit as em

    lanes, tables = _emit_arrays(emit_chunk_cases(), card)
    want = _emit_equal(*lanes, *tables)
    side = torch.cuda.Stream()
    for stream in (side, torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            got = em.emit(*lanes, *tables)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    shape = em.launch_shape(lanes[1].shape[0], lanes[5])
    assert shape["tile"] == 2048
    assert shape["blocks"] == -(-lanes[1].shape[0] * -(-lanes[5] // 2048)
                                // 2)
    assert 0 < shape["blocks"] <= shape["resident"] * \
        torch.cuda.get_device_properties(0).multi_processor_count


def test_emit_kernel_equals_plain_on_trap_windows(card):
    """The L6 trap windows through the match, select and table kernels,
    as the L6 flow runs them, then the emit kernel in both modes."""
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dt
    from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ed

    _, rows, valid, hist, s = l6_windows()
    rows, valid, hist = (torch.from_numpy(x).to(card)
                         for x in (rows, valid, hist))
    block = s - ed.HIST
    ml, dist, sel, lit, llh, ofh = ed.analyze_block_l6(rows, valid, hist,
                                                       block)
    finals = torch.zeros(rows.shape[0], dtype=torch.bool, device=card)
    ll, of, _, hdr_bits = dt.build_tables(llh, ofh, finals)
    lanes = (rows[:, ed.HIST:], ml, dist, sel, lit, block)
    _emit_equal(*lanes, ll, of, hdr_bits)
    _emit_equal(*lanes)


@pytest.mark.parametrize("block", [16384, 65536])
@pytest.mark.parametrize("kind", ["text", "random", "zeros", "pattern",
                                  "periodic:7"])
@pytest.mark.parametrize("tier", ["l6", "l4", "static"])
def test_emit_kernel_equals_plain_on_flow_rows(card, tier, kind, block):
    """The L6, L4 and L1 tiers' emit inputs from their kernels (a first
    and a short last block; the L6 bytes and distances column slices of
    wider rows)."""
    data = make_corpus(kind, 2 * block + 777, seed=len(kind))
    level = {"l6": 6, "l4": 4, "static": 1}[tier]
    lanes, tables = emit_pass_inputs([data], level, block, card)
    if tier == "l6":
        assert lanes[0].stride(1) == 1 and lanes[2].stride(0) > block
    _emit_equal(*lanes, *tables)


def test_emit_kernel_empty_batch_and_guards(card):
    from libdeflate_rsx_tpu_torch.ops import emit as em

    s = 1024
    none = torch.zeros((0, s), dtype=torch.int64, device=card)
    nob = none.bool()
    data = torch.zeros((0, s + 8), dtype=torch.uint8, device=card)
    tabs = (torch.zeros((0, 288), dtype=torch.int32, device=card),
            torch.zeros((0, 30), dtype=torch.int32, device=card),
            torch.zeros(0, dtype=torch.int64, device=card))
    for tables in (tabs, ()):
        got = _emit_equal(data, none, none, nob, nob, s, *tables)
        assert got[0].shape == (0, s // 32, 65 if tables else 49)
        assert got[3].shape == (0,)
    one = torch.zeros((1, s), dtype=torch.int64, device=card)
    rows = torch.zeros((1, s + 8), dtype=torch.uint8, device=card)
    before = em.LAUNCHES
    with pytest.raises(ValueError):                  # rows of 32 lanes
        em.emit(rows, one[:, :s - 8], one[:, :s - 8], one[:, :s - 8].bool(),
                one[:, :s - 8].bool(), s - 8)
    with pytest.raises(ValueError):
        em.emit(rows, one.int(), one, one.bool(), one.bool(), s)
    with pytest.raises(ValueError):
        em.emit(rows[:, :s - 1], one, one, one.bool(), one.bool(), s)
    with pytest.raises(ValueError):                  # a table short
        em.emit(rows, one, one, one.bool(), one.bool(), s,
                torch.zeros((1, 287), dtype=torch.int32, device=card),
                torch.zeros((1, 30), dtype=torch.int32, device=card),
                torch.zeros(1, dtype=torch.int64, device=card))
    assert em.LAUNCHES == before
