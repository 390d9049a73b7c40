"""The segment route of pass 1 (ops/inflate_tokens.py) on the CPU.

`pass1` on CPU tensors runs the route's finder, chain and emit in plain
PyTorch with the plain segment decoder, as the card runs them with its
kernels. These tests hold it to the whole-stream serial decode,
`pass1_plain`, on streams that exercise each rule of the route, and one
batch to the JAX package's pass-1 kernel in interpret mode (the suite's
shared bucket: s=1, max_steps=2048). Tolerance: exact equality.

`sync_cases()` is shared with `tests/test_torch_cuda.py`, which holds the
kernels to the plain version on the same streams; this module imports
nothing of JAX at import time, as the card's machine has none.
"""

import random
import zlib

import numpy as np
import pytest
import torch

from _port_corpus import make_corpus
from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor, convert
from libdeflate_rsx_tpu_torch.models.greedy_dynamic import deflate_device_l6
from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

torch.set_num_threads(2)
MARK = b"\x00\x00\xff\xff"


def flushed(pieces, level=6, mode=zlib.Z_SYNC_FLUSH, finish=True):
    """Raw DEFLATE of the pieces with a flush after each but the last:
    (stream, byte offsets of the sync points, each just past its 00 00
    FF FF)."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    out, syncs = b"", []
    for k, p in enumerate(pieces):
        out += co.compress(p)
        if k < len(pieces) - 1:
            out += co.flush(mode)
            syncs.append(len(out))
    if finish:
        out += co.flush()
    else:
        out += co.flush(zlib.Z_SYNC_FLUSH)
    return out, syncs


def _split(data, n):
    step = len(data) // n
    return [data[k * step:(k + 1) * step if k < n - 1 else len(data)]
            for k in range(n)]


def sync_cases():
    """(name, stream, out_cap) of streams with sync points: matches that
    reach back across a sync point, stored data holding 00 00 FF FF
    (false candidates), out_cap reached in the third segment, a final
    empty stored block, a stream that ends at a sync point, and a
    segment that starts in its stream's last bytes."""
    text = make_corpus("text", 6000, seed=3)
    marked = (b"ab" + MARK + b"cd") * 300
    cases = [
        ("sync-text", flushed(_split(text, 5))[0], 65536),
        ("full-flush", flushed(_split(text, 4),
                               mode=zlib.Z_FULL_FLUSH)[0], 65536),
        ("stored-marks", flushed(_split(marked, 3), level=0)[0], 65536),
        ("dynamic-marks", flushed(_split(marked + text[:900], 3))[0], 65536),
        ("cap-third", flushed(_split(text[:4000], 4))[0], 2500),
        ("final-empty-stored",
         flushed(_split(text[:3000], 3), finish=False)[0] + b"\x01" + MARK,
         65536),
        ("ends-at-sync", flushed(_split(text[:3000], 3), finish=False)[0],
         65536),
        ("short-last", flushed([text[:2000], b"x"])[0], 65536),
        # ~2 bits a token: the later segments' tokens pass their scratch
        ("scratch-overflow", flushed([bytes(60000)] * 3)[0], 1 << 18),
    ]
    return cases


def bit_flipped(n, seed=9):
    """n multi-segment streams with 1-3 flipped bits each."""
    r = random.Random(seed)
    out = []
    for k in range(n):
        d = make_corpus(("text", "pattern")[k % 2], 2400 + 50 * k, seed=k)
        s = bytearray(flushed(_split(d, 3 + k % 3), level=(1, 6, 9)[k % 3])[0])
        for _ in range(1 + k % 3):
            bit = r.randrange(8 * len(s))
            s[bit >> 3] ^= 1 << (bit & 7)
        out.append(bytes(s))
    return out


def _both(streams, out_cap):
    args = it.pack_streams(streams, 65536, "cpu")[:3]
    return it.pass1(*args, out_cap), it.pass1_plain(*args, out_cap), args


CASES = sync_cases()


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("mode", [zlib.Z_SYNC_FLUSH, zlib.Z_FULL_FLUSH])
def test_finder_returns_every_sync_point(mode, level):
    d = make_corpus("text", 5000, seed=level)
    z, syncs = flushed(_split(d, 6), level=level, mode=mode)
    args = it.pack_streams([b"\x03\x00", z], 65536, "cpu")[:3]
    st, bit, first = it.find_segments(*args)
    assert first.tolist() == [0, 1, len(st)]
    assert st.tolist() == [0] + [1] * (len(st) - 1)
    found = set(bit[1:].tolist())
    assert bit[1] == 0 and {8 * p for p in syncs} <= found
    # without sync stops every stream is one segment from bit 0
    st, bit, first = it.find_segments(*args, sync_stops=False)
    assert bit.tolist() == [0, 0] and first.tolist() == [0, 1, 2]


def test_finder_returns_every_block_boundary_of_an_l6_item():
    """Each block boundary of an L6 item is found: the stream from that
    candidate decodes (zlib, with the data before it as history) to the
    rest of the data."""
    block = 8192
    d = make_corpus("text", 4 * block + 1000, seed=4)
    z = deflate_device_l6(d, block_size=block, device="cpu")
    args = it.pack_streams([z], 65536, "cpu")[:3]
    _, bit, _ = it.find_segments(*args)
    starts = [b // 8 for b in bit.tolist()]

    def resumes(q, k):
        dec = zlib.decompressobj(-15, zdict=d[max(0, k * block - 32768):
                                              k * block])
        try:
            return dec.decompress(z[q:]) == d[k * block:]
        except zlib.error:
            return False

    for k in range(1, 5):
        assert any(resumes(q, k) for q in starts[1:]), k
    (tok, st), (ptok, pst), _ = _both([z], 65536)
    assert torch.equal(tok, ptok) and torch.equal(st, pst)
    assert st[0, 0] == it.DONE and st[0, 1] == len(d)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_segment_route_equals_serial_decode(name):
    """pass1 (segments) equals pass1_plain (whole streams), tokens and
    stats, and the counts say which route the stream took."""
    _, z, out_cap = next(c for c in CASES if c[0] == name)
    before = (it.SEGMENTS, it.FALSE_CANDIDATES, it.CONFIRMED, it.RERUNS)
    (tok, st), (ptok, pst), args = _both([z], out_cap)
    assert torch.equal(st, pst) and torch.equal(tok, ptok)
    segs, false, confirmed, reruns = (a - b for a, b in zip(
        (it.SEGMENTS, it.FALSE_CANDIDATES, it.CONFIRMED, it.RERUNS), before))
    assert confirmed + reruns == 1
    expect = {"cap-third": (it.BAD, 1), "ends-at-sync": (it.BAD, 1)}
    mode, rerun = expect.get(name, (it.DONE, 0))
    assert st[0, 0] == mode and reruns == rerun
    assert segs >= 2
    if name == "stored-marks":
        assert false > 0
    if name == "sync-text":
        # some match reaches back across a sync point
        s, bit, _ = it.find_segments(*args)
        res = it._decode_rows(*args, out_cap, s, bit, True, bit == 0,
                              torch.zeros(1, dtype=torch.int32),
                              bit * 0, bit * 0)
        assert int(res[1:, 4].max()) > 0


def test_segment_route_in_one_batch_with_every_case():
    """All cases in one batch at one out_cap, beside single-segment
    streams: the rows do not disturb each other."""
    streams = [z for _, z, _ in CASES] + [flushed([b"plain" * 99])[0],
                                          b"", b"\x07\x00"]
    for out_cap in (2500, 65536):
        (tok, st), (ptok, pst), _ = _both(streams, out_cap)
        assert torch.equal(st, pst) and torch.equal(tok, ptok)


def test_segment_route_on_bit_flipped_streams():
    reruns = it.RERUNS
    (tok, st), (ptok, pst), _ = _both(bit_flipped(24), 65536)
    assert torch.equal(st, pst) and torch.equal(tok, ptok)
    assert set(st[:, 0].tolist()) == {it.DONE, it.BAD}
    assert it.RERUNS > reruns


def test_serial_route_equals_segment_route():
    """The private serial route (sync stops off) decodes each stream as
    one segment, to the same result."""
    streams = [z for _, z, _ in CASES]
    args = it.pack_streams(streams, 65536, "cpu")[:3]
    segs = it.SEGMENTS
    tok, st = it.pass1(*args, 65536, _sync_stops=False)
    assert it.SEGMENTS == segs + len(streams)
    ptok, pst = it.pass1(*args, 65536)
    assert torch.equal(st, pst) and torch.equal(tok, ptok)


def test_segment_route_equals_jax_kernel():
    """One batch of short multi-segment streams, plain and bit-flipped,
    against the JAX pass-1 kernel in interpret mode: per-stream verdicts,
    output lengths and NOP-stripped tokens."""
    from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as jitk

    text = make_corpus("text", 900, seed=8)
    streams = [flushed(_split(text, 3))[0],
               flushed(_split(text[:600], 3), mode=zlib.Z_FULL_FLUSH)[0],
               flushed(_split((b"a" + MARK) * 60, 2), level=0)[0],
               flushed(_split(text[:500], 2), finish=False)[0] + b"\x01"
               + MARK]
    r = random.Random(3)
    for k in range(4):
        s = bytearray(streams[k % 2])
        bit = r.randrange(8 * len(s))
        s[bit >> 3] ^= 1 << (bit & 7)
        streams.append(bytes(s))
    raw = {}
    real = jitk._jit_pass1

    def spy(*a, **k):
        run = real(*a, **k)

        def run_and_keep(*args):
            raw["out"] = run(*args)
            return raw["out"]
        return run_and_keep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitk, "_jit_pass1", spy)
        jitk.decode_tokens_device(streams, s=1, max_steps=2048)
    jtok, jst, _ = convert.from_jax_pass1(
        *(np.asarray(x) for x in raw["out"]), len(streams), 1)
    args = it.pack_streams(streams, 65536, "cpu")[:3]
    tok, st = it.pass1(*args, jitk.OUT_CAP)
    assert set(jst[:, 0].tolist()) <= {it.DONE, it.BAD}  # budget held
    assert np.array_equal(st.numpy(), jst)
    for i in range(len(streams)):
        n = int(jst[i, 3])
        assert np.array_equal(tok[i, :n].numpy(), jtok[i, :n])
        assert not tok[i, n:].any()


def test_device_tiers_default_to_the_card():
    """use_device=True without device= means the card: without one the
    batch raises instead of running the plain versions on the CPU; the
    auto mode still picks the host engine there."""
    d = [make_corpus("text", 5000, seed=1)] * 8
    bc = BatchCompressor(level=6, use_device=True)
    bd = BatchDecompressor(use_device=True)
    assert bc.device.type == "cuda" and bd.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            bc.compress_batch(d)
        with pytest.raises((RuntimeError, AssertionError)):
            bd.decompress_batch([zlib.compress(x)[2:-4] for x in d],
                                [5000] * 8)
        auto = BatchCompressor(level=6).compress_batch(d[:1])
        assert zlib.decompress(auto[0], -15) == d[0]
