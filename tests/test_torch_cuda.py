"""The port on a CUDA card: the pass-1, inflate_v2 and inflate_static
kernels against their plain PyTorch versions on the card, and the slice
through the kernels. Every test here needs a card and skips without one.

Run on a machine with a card (the suite's conftest.py imports jax, which
such a machine need not have): python -m pytest --noconftest
tests/test_torch_cuda.py
"""

import random
import zlib

import pytest
import torch

from _port_corpus import make_corpus, mutated_streams

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


@pytest.mark.parametrize("name", ["inflate_v2", "inflate_static"])
def test_stream_kernel_equals_plain_on_card(card, name):
    """Every output word equal (bytes, flags, count), and the launch
    counted."""
    import importlib

    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    mod = importlib.import_module("libdeflate_rsx_tpu_torch.ops." + name)
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")
    lens, words = v2.pack(_stream_cases(), card)
    before = mod.LAUNCHES
    out_k = kernel(lens, words)
    assert mod.LAUNCHES == before + 1
    out_p = plain(lens, words)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)
    empty = kernel(*v2.pack([], card))
    assert empty.shape == (0, v2.OUT_WORDS) and mod.LAUNCHES == before + 1


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
