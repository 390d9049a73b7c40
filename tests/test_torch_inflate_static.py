"""Stored/static decode: the plain version of the port's inflate_static
kernel against the JAX package's Pallas kernel
(ops/pallas/inflate_static.py), in interpret mode on the CPU. Per stream
the count word (-1 for a bad stream) and the decoded bytes must agree."""

import random
import zlib

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.ops.pallas import inflate_static as jst
from libdeflate_rsx_tpu_torch.ops import inflate_device_static
from libdeflate_rsx_tpu_torch.ops import inflate_static as st
from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2
from tests._port_corpus import edge_cases, edge_rows
from tests.conftest import make_corpus

torch.set_num_threads(2)

KINDS = ["text", "random", "pattern", "zeros", "periodic:7"]


def _fixed(data, level=6):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    return c.compress(data) + c.flush()


def _stored(data):
    return zlib.compress(data, 0)[2:-4]


def _cases():
    """(stream, expected bytes, None for "bad", or ... for "any")."""
    cases = []
    for i, kind in enumerate(KINDS):
        d = make_corpus(kind, 3000 + 500 * i, seed=i)
        cases += [(_fixed(d, (1, 6, 9)[i % 3]), d), (_stored(d), d),
                  (zlib.compress(d, 6)[2:-4], ...)]
    d = make_corpus("text", 6000, seed=7)
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    multi = co.compress(d[:2500]) + co.flush(zlib.Z_FULL_FLUSH) \
        + co.compress(d[2500:]) + co.flush()
    cases += [(multi, d), (_stored(d)[:3000], None), (_fixed(d)[:900], ...),
              (b"", b""), (b"\x03\x00", b""), (b"\x01\x00", None),
              (b"\x05\x00", None), (b"\x07", None),
              (_stored(bytes(70000)), ...)]   # over IN_CAP: packed empty
    r = random.Random(3)
    for k in range(32):
        s = bytearray(_fixed(make_corpus("text", 400 + 20 * k, seed=k)) if k % 2
                      else _stored(make_corpus("pattern", 300, seed=k)))
        for _ in range(1 + k % 3):
            bit = r.randrange(8 * min(len(s), 40 if k % 4 == 0 else len(s)))
            s[bit >> 3] ^= 1 << (bit & 7)
        cases.append((bytes(s), ...))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def words():
    """(JAX out words, plain out words) for every case."""
    import jax.numpy as jnp
    lens, wds = v2.pack([s for s, _ in CASES])
    jw = jst._jit_inflate()(jnp.asarray(lens.numpy()), jnp.asarray(wds.numpy()))
    return (np.asarray(jw).reshape(len(CASES), st.OUT_WORDS),
            st.inflate_static(lens, wds).numpy())


@pytest.mark.parametrize("k", range(len(CASES)))
def test_plain_equals_jax_kernel(words, k):
    jw, pw = words[0][k], words[1][k]
    stream, want = CASES[k]
    n = int(jw[-1])
    assert int(pw[-1]) == n
    if n >= 0:
        assert pw.view("<u1")[:n].tobytes() == jw.view("<u1")[:n].tobytes()
        assert not pw.view("<u1")[n:st.OUT_CAP].any()
    if want is None:
        assert n < 0
    elif want is not ...:
        assert pw.view("<u1")[:n].tobytes() == want


EDGE = edge_cases()


@pytest.fixture(scope="module")
def edge_words():
    """(JAX out words, plain out words) of the hand-built edge rows."""
    import jax.numpy as jnp
    lens, wds = edge_rows(EDGE)
    jw = jst._jit_inflate()(jnp.asarray(lens), jnp.asarray(wds))
    pw = st.inflate_static(torch.from_numpy(lens), torch.from_numpy(wds.copy()))
    return np.asarray(jw).reshape(len(EDGE), st.OUT_WORDS), pw.numpy()


@pytest.mark.parametrize("k", range(len(EDGE)), ids=[n for n, _, _ in EDGE])
def test_plain_equals_jax_kernel_on_edge_rows(edge_words, k):
    """Rows filled to their last byte, bits read past the row (zero bits
    there), bytes past a stream's end (never read), matches at distances
    31-33, 64 and 32,768: the count and the decoded bytes equal."""
    jw, pw = edge_words[0][k], edge_words[1][k]
    name, stream, _ = EDGE[k]
    n = int(jw[-1])
    assert int(pw[-1]) == n
    assert pw.view("<u1")[:max(n, 0)].tobytes() \
        == jw.view("<u1")[:max(n, 0)].tobytes()
    if n >= 0:
        assert not pw.view("<u1")[n:st.OUT_CAP].any()
    dynamic = name.startswith(("dynamic", "long-codes", "oversub"))
    if "cut" not in name and not dynamic and name != "static-past-row":
        assert pw.view("<u1")[:n].tobytes() == zlib.decompress(stream, -15)
    assert (n < 0) == (dynamic or name == "stored-65535-cut")


def test_dynamic_blocks_are_bad(words):
    dyn = [k for k, (s, _) in enumerate(CASES) if s and (s[0] >> 1) & 3 == 2]
    assert len(dyn) >= 3
    assert all(words[1][k, -1] == -1 for k in dyn)


def test_inflate_device_static_matches_the_jax_wrapper(words):
    streams = [s for s, _ in CASES]
    got = inflate_device_static(streams, "cpu")
    jw = words[0]
    want = [None if len(s) > st.IN_CAP or jw[i, -1] < 0
            else jw[i].view("<u1")[:jw[i, -1]].tobytes()
            for i, s in enumerate(streams)]
    assert got == want
    assert got[-33] is None                       # over the input cap


def test_wrapper_rules():
    lens, wds = v2.pack([_fixed(b"hello")])
    with pytest.raises(ValueError):
        st.inflate_static(lens, wds.to(torch.int64))
    with pytest.raises(ValueError):
        st.inflate_static(lens[:0], wds)
    with pytest.raises(ValueError):
        st.inflate_static(lens.to("meta"), wds.to("meta"))
    before = st.LAUNCHES
    out = st.inflate_static(lens, wds)
    assert st.LAUNCHES == before          # a CPU tensor takes the plain path
    assert out[0, -1] == 5 and out[0].numpy().view("<u1")[:5].tobytes() \
        == b"hello"
    assert st.inflate_static(*v2.pack([])).shape == (0, st.OUT_WORDS)
