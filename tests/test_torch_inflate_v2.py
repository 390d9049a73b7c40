"""The small-batch decoder: the plain version of the port's inflate_v2
kernel against the JAX package's Pallas kernel (ops/pallas/inflate_v2.py,
in interpret mode on the CPU, as tests/test_device_inflate.py runs it),
and the port's BatchDecompressor on batches below SMALL_BATCH against the
JAX package's.

Per stream the output words must agree: the count word (-1 for a bad
stream), the decoded bytes, and the flag word. The JAX kernel keeps its
code lengths in scratch memory that carries over from the previous
stream; a dynamic header whose code lengths stop short
(BAD_LENS_COUNT) then builds its tables from those, so for such a stream
the flag bits that read the tables (BAD_OVERSUB, BAD_TABLE, BAD_NO_EOB)
are left out of the comparison."""

import random
import zlib

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu import batch as jbatch
from libdeflate_rsx_tpu.ops.pallas import inflate_v2 as jv2
from libdeflate_rsx_tpu_torch import BatchDecompressor
from libdeflate_rsx_tpu_torch.batch import SMALL_BATCH
from libdeflate_rsx_tpu_torch.ops import inflate_tokens
from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2
from tests._port_corpus import edge_cases, edge_rows, mutated_streams
from tests.conftest import make_corpus

torch.set_num_threads(2)

STALE = v2.BAD_OVERSUB | v2.BAD_TABLE | v2.BAD_NO_EOB


def _z(data, level=6):
    return zlib.compress(data, level)[2:-4]


def _named_cases():
    """(stream, expected bytes or None for "bad", or ... for "any") of
    tests/test_device_inflate.py, in its order."""
    cases = []
    pattern = make_corpus("pattern", 30000, seed=3)
    for d, lvl in ((b"ab" * 2000, 9), (make_corpus("text", 20000), 6),
                   (b"hi", 6), (pattern, 0),
                   (make_corpus("random", 2000), 6), (b"\0" * 40000, 6)):
        cases.append((_z(d, lvl), d))
    data = make_corpus("text", 15000, seed=9)
    cases += [(_z(data, lvl), data) for lvl in range(10)]
    r = random.Random(77)
    cases += [(bytes(r.randrange(256) for _ in range(r.randrange(1, 200))),
               ...) for _ in range(6)]
    cases.append((_z(b"sane data " * 50), b"sane data " * 50))
    text = make_corpus("text", 20000, seed=1)
    cases += [(_z(text)[:len(_z(text)) // 2], None), (_z(text), text)]
    cases.append((_z(make_corpus("random", 80000, seed=2)), None))  # > cap
    cases += [(b"", None), (b"\x07\x00", None)]
    return cases


def _offset_cases():
    cases = []
    for off in (1, 2, 3, 4, 5, 7, 8, 15, 16, 17, 300):
        r = random.Random(off)
        base = bytes(r.randrange(256) for _ in range(off))
        data = (base * (20000 // off + 2))[:20000]
        cases.append((_z(data), data))
    cap = v2.OUT_CAP
    r = random.Random(5)
    for s in (cap - 4, cap - 1, cap, cap + 1, cap + 4, 66000, 70000):
        d = bytes(r.randrange(256) for _ in range(100)) * (s // 100) \
            + b"x" * (s % 100)
        cases.append((_z(d), ...))
    return cases


GROUPS = {
    "named": _named_cases(),
    "offsets": _offset_cases(),
    "flipped": [(s, ...) for s in mutated_streams(32, seed=8)],
}


def _jax_words(streams):
    lens, words = v2.pack(streams)
    import jax.numpy as jnp
    out = jv2._jit_inflate(len(streams))(jnp.asarray(lens.numpy()),
                                         jnp.asarray(words.numpy()))
    return np.asarray(out).reshape(len(streams), v2.OUT_WORDS)


@pytest.fixture(scope="module")
def words():
    """group -> (JAX out words, plain out words)."""
    res = {}
    for name, cases in GROUPS.items():
        streams = [s for s, _ in cases]
        res[name] = (_jax_words(streams), v2.decode_words(streams, "cpu"))
    return res


@pytest.mark.parametrize("group,k", [(g, k) for g, c in GROUPS.items()
                                     for k in range(len(c))])
def test_plain_equals_jax_kernel(words, group, k):
    jw, pw = (w[k] for w in words[group])
    stream, want = GROUPS[group][k]
    n = int(jw[-1])
    assert int(pw[-1]) == n
    assert v2.row_bytes(pw) == v2.row_bytes(jw)
    jf, pf = int(jw[-2]), int(pw[-2])
    if jf & v2.BAD_LENS_COUNT:
        jf, pf = jf & ~STALE, pf & ~STALE
    assert pf == jf
    assert (n < 0) == (pf != 0)
    if want is None:
        assert n < 0
    elif want is not ...:
        assert v2.row_bytes(pw) == want
    if n >= 0:                       # nothing past the count
        assert not pw.view("<u1")[n:v2.OUT_CAP].any()


EDGE = edge_cases()


@pytest.fixture(scope="module")
def edge_words():
    """(JAX out words, plain out words) of the hand-built edge rows: one
    more batch for the JAX kernel."""
    import jax.numpy as jnp
    lens, wds = edge_rows(EDGE)
    jw = jv2._jit_inflate(len(EDGE))(jnp.asarray(lens), jnp.asarray(wds))
    pw = v2.inflate_v2(torch.from_numpy(lens), torch.from_numpy(wds.copy()))
    return np.asarray(jw).reshape(len(EDGE), v2.OUT_WORDS), pw.numpy()


@pytest.mark.parametrize("k", range(len(EDGE)), ids=[n for n, _, _ in EDGE])
def test_plain_equals_jax_kernel_on_edge_rows(edge_words, k):
    """Rows filled to their last byte, bits read past the row (they wrap
    to its start), bytes past a stream's end, matches at distances 31-33,
    64 and 32,768, 15-bit codes: the count, the decoded bytes and the
    flag word equal, and nothing past the count."""
    jw, pw = edge_words[0][k], edge_words[1][k]
    name, stream, _ = EDGE[k]
    n = int(jw[-1])
    assert int(pw[-1]) == n
    jf, pf = int(jw[-2]), int(pw[-2])
    if jf & v2.BAD_LENS_COUNT:       # the JAX kernel's carried-over lengths
        jf, pf = jf & ~STALE, pf & ~STALE
    assert pf == jf
    assert v2.row_bytes(pw) == v2.row_bytes(jw)
    assert not pw.view("<u1")[max(n, 0):v2.OUT_CAP].any() or n < 0
    d = zlib.decompressobj(-15)
    try:
        want = d.decompress(stream)
    except zlib.error:
        want = None
    if want is not None and d.eof:
        assert v2.row_bytes(pw) == want and pw[-2] == 0
    else:
        assert n < 0


def test_inflate_device_matches_the_jax_wrapper(words):
    """bytes | None per stream, an empty stream and one over the cap
    included, as the JAX wrapper returns them."""
    cases = GROUPS["named"]
    streams = [s for s, _ in cases]
    got = v2.inflate_device(streams, "cpu")
    jw = words["named"][0]
    want = [v2.row_bytes(jw[i]) if 0 < len(s) <= v2.IN_CAP else None
            for i, s in enumerate(streams)]
    assert got == want
    assert got[:2] == [cases[0][1], cases[1][1]]
    assert got[-3:] == [None, None, None]


def test_flag_words_name_their_causes(words):
    """The test streams reach many causes, and an output past the cap
    names BAD_OUT_CAP."""
    flags = np.concatenate([w[1][:, -2] for w in words.values()])
    seen = int(np.bitwise_or.reduce(flags))
    assert seen & v2.BAD_OUT_CAP and seen & v2.BAD_BLOCK_END
    assert bin(seen).count("1") >= 6
    assert int(words["offsets"][1][-1, -2]) & v2.BAD_OUT_CAP   # 70000 B


def test_wrapper_rules():
    lens, wds = v2.pack([_z(b"hello")])
    with pytest.raises(ValueError):
        v2.inflate_v2(lens.to(torch.int64), wds)
    with pytest.raises(ValueError):
        v2.inflate_v2(lens, wds[:, :100].contiguous())
    with pytest.raises(ValueError):
        v2.inflate_v2(lens + v2.IN_CAP, wds)
    with pytest.raises(ValueError):
        v2.inflate_v2(lens.to("meta"), wds.to("meta"))
    before = v2.LAUNCHES
    out = v2.inflate_v2(lens, wds)
    assert v2.LAUNCHES == before          # a CPU tensor takes the plain path
    assert out.shape == (1, v2.OUT_WORDS) and out.dtype == torch.int32
    assert v2.row_bytes(out[0].numpy()) == b"hello"
    assert v2.inflate_v2(*v2.pack([])).shape == (0, v2.OUT_WORDS)


def _frame(fmt, data):
    from libdeflate_rsx_tpu_torch import Compressor
    return getattr(Compressor(6), "compress_" + fmt)(data)


@pytest.mark.parametrize("n", range(1, SMALL_BATCH))
def test_small_batches_equal_the_jax_package(n):
    items = [make_corpus(("text", "pattern", "random")[i % 3], 3000 + 700 * i,
                         seed=i) for i in range(n)]
    comp = [_frame("deflate", d) for d in items]
    caps = [len(d) for d in items]
    launches = inflate_tokens.LAUNCHES
    bd = BatchDecompressor(use_device=True, device="cpu")
    got = bd.decompress_batch(comp, caps)
    ref = jbatch.BatchDecompressor(use_device=True).decompress_batch(comp, caps)
    assert got == ref == items
    assert not bd.fallbacks
    assert inflate_tokens.LAUNCHES == launches


@pytest.mark.parametrize("fmt", ["deflate", "zlib", "gzip"])
def test_small_batch_fallbacks_counted_by_cause(fmt):
    text = make_corpus("text", 9000, seed=4)
    good = _frame(fmt, text)
    big = _frame(fmt, make_corpus("random", 70000, seed=2))  # > 64 KiB in
    inputs = [good, _frame(fmt, b"\xff" * 100), big, good]
    caps = [len(text), 100, 70000, 50]
    want = {"in_cap": 1, "max_out": 1}
    if fmt == "deflate":
        inputs.append(b"\xff\x07garbage")            # bad: the host fails too
        want["v2"] = 1
    else:
        inputs += [good[:-1] + bytes([good[-1] ^ 1]), b"\x00\x01"]
        want.update(checksum=1, container=1)
    caps += [len(text)] * (len(inputs) - len(caps))
    bd = BatchDecompressor(format=fmt, use_device=True, device="cpu")
    got = bd.decompress_batch(inputs, caps)
    ref = jbatch.BatchDecompressor(format=fmt, use_device=True) \
        .decompress_batch(inputs, caps)
    assert got == ref
    assert got[:4] == [text, b"\xff" * 100, ref[2], None]
    assert got[2] is not None
    assert dict(bd.fallbacks) == want


def test_small_batch_output_cap_counted():
    """An item whose output passes the kernel's cap is "out_cap" when its
    max_out is over that cap (the host decodes it), else "max_out"."""
    big = bytes(80000)
    bd = BatchDecompressor(use_device=True, device="cpu")
    got = bd.decompress_batch([_z(big), _z(big)], [len(big), 65536])
    assert got == [big, None]
    assert dict(bd.fallbacks) == {"out_cap": 1, "max_out": 1}
