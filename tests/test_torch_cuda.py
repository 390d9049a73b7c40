"""The port on a CUDA card: the pass-1, inflate_v2 and inflate_static
kernels against their plain PyTorch versions on the card, the slice
through the kernels, the level 0-5 compress tiers (card bytes equal to
CPU bytes, decoded through the kernels) and the device checksums under
TF32 and bf16 matmul precision. Every test here needs a card and skips
without one.

Run on a machine with a card (the suite's conftest.py imports jax, which
such a machine need not have): python -m pytest --noconftest
tests/test_torch_cuda.py
"""

import random
import zlib

import numpy as np
import pytest
import torch

from _port_corpus import edge_cases, edge_rows, make_corpus, mutated_streams

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
