"""The whole slice on the CPU: BatchCompressor(level=6) through the L6
tier and BatchDecompressor through the two-pass decoder, on
device="cpu" (the plain pass 1, no kernel launch). The compressed bytes
must equal the JAX model's payload with the same framing; decoding must
be byte-exact, with every host fallback counted by cause. The decode
batches here hold at least SMALL_BATCH items, so that they take the
two-pass decoder (smaller ones: tests/test_torch_inflate_v2.py)."""

import gzip
import zlib

import pytest
import torch

from libdeflate_rsx_tpu import batch as jbatch
from libdeflate_rsx_tpu.models.greedy_dynamic import deflate_device_l6_many
from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor
from libdeflate_rsx_tpu_torch.batch import SMALL_BATCH
from libdeflate_rsx_tpu_torch.ops import inflate_tokens
from tests.conftest import make_corpus

torch.set_num_threads(2)

DATAS = [make_corpus("text", 70000, seed=1), make_corpus("pattern", 20000),
         make_corpus("random", 3000, seed=2), b"x"]


@pytest.fixture(scope="module")
def jax_payloads():
    return deflate_device_l6_many(DATAS)


def _unframe(fmt, blob):
    if fmt == "deflate":
        return zlib.decompress(blob, -15)
    if fmt == "zlib":
        return zlib.decompress(blob)
    return gzip.decompress(blob)


@pytest.mark.parametrize("fmt", ["deflate", "zlib", "gzip"])
def test_compress_decompress_slice(fmt, jax_payloads):
    launches = inflate_tokens.LAUNCHES
    bc = BatchCompressor(level=6, format=fmt, use_device=True, device="cpu")
    out = bc.compress_batch(DATAS)
    ref = jbatch.BatchCompressor(level=6, format=fmt)
    assert out == [ref._frame(d, p) for d, p in zip(DATAS, jax_payloads)]
    for d, o in zip(DATAS, out):
        assert _unframe(fmt, o) == d

    bd = BatchDecompressor(format=fmt, use_device=True, resolve="device",
                           device="cpu")
    got = bd.decompress_batch(out * 2, [len(d) for d in DATAS] * 2)
    assert got == DATAS * 2
    assert not bd.fallbacks
    assert inflate_tokens.LAUNCHES == launches     # CPU: plain version


def test_decompress_fallbacks_counted_by_cause():
    comp = BatchCompressor(level=6, use_device=True,
                           device="cpu").compress_batch(DATAS[:2])
    big = zlib.compress(bytes(1_100_000), 0)[2:-4]        # > 1 MiB payload
    pad = [comp[1]] * (SMALL_BATCH - 5)
    inputs = comp + [b"\xff\x07garbage", comp[1], big] + pad
    caps = [len(DATAS[0]), len(DATAS[1]), 100, 1000, 1_100_000] \
        + [len(DATAS[1])] * len(pad)
    for resolve in ("device", "host"):
        bd = BatchDecompressor(use_device=True, resolve=resolve,
                               device="cpu")
        got = bd.decompress_batch(inputs, caps)
        assert got[:2] == DATAS[:2]
        assert got[2] is None                   # garbage: host fails too
        assert got[3] is None                   # over its max_out
        assert got[4] == bytes(1_100_000)       # over the in-cap: host
        assert got[5:] == DATAS[1:2] * len(pad)
        assert dict(bd.fallbacks) == {"pass1": 1, "max_out": 1,
                                      "in_cap": 1}


def test_out_cap_fallbacks_counted_apart():
    """A well-formed item whose output passes the batch's out_cap is not
    counted as malformed: "out_cap" when its max_out is over the device
    cap (the host decodes it), "max_out" when it is not (nothing does)."""
    big = bytes((1 << 20) + 4096)
    pad = [b"x"] * (SMALL_BATCH - 2)
    bd = BatchDecompressor(use_device=True, resolve="device", device="cpu")
    got = bd.decompress_batch(
        [zlib.compress(big, 6)[2:-4], b"\xff\x07"]
        + [zlib.compress(p, 6)[2:-4] for p in pad],
        [len(big), 100] + [1] * len(pad))
    assert got == [big, None] + pad
    assert dict(bd.fallbacks) == {"out_cap": 1, "pass1": 1}
    pad = [b"x"] * (SMALL_BATCH - 1)
    bd = BatchDecompressor(use_device=True, resolve="device", device="cpu")
    got = bd.decompress_batch(
        [zlib.compress(bytes(70000), 6)[2:-4]]
        + [zlib.compress(p, 6)[2:-4] for p in pad], [65536] + [1] * len(pad))
    assert got == [None] + pad
    assert dict(bd.fallbacks) == {"max_out": 1}


def test_container_and_checksum_fallbacks():
    bc = BatchCompressor(level=6, format="zlib", use_device=True,
                         device="cpu")
    good = bc.compress_batch(DATAS[1:2])[0]
    corrupt = good[:-1] + bytes([good[-1] ^ 1])          # adler mismatch
    bd = BatchDecompressor(format="zlib", use_device=True, resolve="device",
                           device="cpu")
    got = bd.decompress_batch([good, corrupt, b"\x00\x01"], [20000] * 3)
    assert got == [DATAS[1], None, None]
    assert dict(bd.fallbacks) == {"checksum": 1, "container": 1}


def test_phase_hook_sees_every_phase_in_order(monkeypatch):
    from libdeflate_rsx_tpu_torch.models import greedy_static

    seen = []
    monkeypatch.setattr(greedy_static, "PHASE_END", seen.append)
    out = BatchCompressor(level=6, use_device=True,
                          device="cpu").compress_batch(DATAS[2:])
    assert [zlib.decompress(o, -15) for o in out] == DATAS[2:]
    assert seen == ["split", "h2d", "analyze", "tables", "emit",
                    "assemble", "d2h", "join"]


def test_routing_rules():
    for level in range(10):           # every device tier, levels 0-9
        assert BatchCompressor(level=level, use_device=True,
                               device="cpu")._device_wanted()
    bc = BatchCompressor(level=6, device="cpu")       # auto mode, no CUDA
    assert not bc._device_wanted()
    out = bc.compress_batch([DATAS[1]])
    assert zlib.decompress(out[0], -15) == DATAS[1]
    assert not BatchCompressor(level=11, use_device=True,
                               device="cpu")._device_wanted()
    dec = BatchDecompressor(use_device=False).decompress_batch(
        out, [len(DATAS[1])])
    assert dec == [DATAS[1]]


def test_ratio_gate_calibrates_once():
    bc = BatchCompressor(level=6, device="cpu")
    assert bc._ratio_calibrate([b"x" * 10]) is False
    assert bc._ratio_ok is None                       # tiny: not cached
    verdict = bc._ratio_calibrate([make_corpus("text", 20000)])
    assert bc._ratio_ok is verdict
    bc._ratio_ok = not verdict                        # cached: no rerun
    assert bc._ratio_calibrate([b"y" * 20000]) is (not verdict)
