"""The L6 encode path: the port's PyTorch functions against the JAX
package's on the CPU, on seeded inputs. Tolerance: exact equality (the
outputs are integers and bytes).

Block size 16384 is the one tests/test_device_dynamic.py compiles. The
JAX model functions are called directly (not through the JAX
BatchCompressor, whose broad except could hide a host-path result)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.models import greedy_dynamic as jgd
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu.ops import static_codes as jsc
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as pgd
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import encode_v2 as pev
from libdeflate_rsx_tpu_torch.ops import static_codes as psc
from tests.conftest import make_corpus

torch.set_num_threads(2)
BLOCK = 16384
KINDS = ("text", "pattern", "random", "zeros", "periodic:7")


def eq(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


# ------------------------------------------------------------ static codes
LENGTHS = np.arange(3, 259, dtype=np.int32)
DISTS = np.arange(1, 32769, dtype=np.int32)


@pytest.mark.parametrize("fn", ["length_sym_fields", "length_fields"])
def test_length_fields_exhaustive(fn):
    got = getattr(psc, fn)(torch.from_numpy(LENGTHS))
    want = jax.jit(getattr(jsc, fn))(jnp.asarray(LENGTHS))
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("fn", ["offset_sym_fields", "offset_fields"])
def test_offset_fields_exhaustive(fn):
    got = getattr(psc, fn)(torch.from_numpy(DISTS))
    want = jax.jit(getattr(jsc, fn))(jnp.asarray(DISTS))
    for g, w in zip(got, want):
        eq(g, w)


def test_literal_match_and_bit_helpers():
    b = np.arange(256, dtype=np.int32)
    for g, w in zip(psc.literal_code(torch.from_numpy(b)),
                    jsc.literal_code(jnp.asarray(b))):
        eq(g, w)
    rng = np.random.default_rng(1)
    ln = rng.integers(3, 259, 5000).astype(np.int32)
    di = rng.integers(1, 32769, 5000).astype(np.int32)
    for g, w in zip(psc.match_token(torch.from_numpy(ln),
                                    torch.from_numpy(di)),
                    jax.jit(jsc.match_token)(jnp.asarray(ln),
                                             jnp.asarray(di))):
        eq(g, w)
    v = np.arange(1 << 16, dtype=np.int32)
    eq(psc.bitrev16(torch.from_numpy(v)), jsc.bitrev16(jnp.asarray(v)))
    x = np.arange(1, 1 << 16, dtype=np.int32)
    eq(psc.bsr(torch.from_numpy(x)), jsc.bsr(jnp.asarray(x)))


# ------------------------------------------------- selection and packing
@pytest.mark.parametrize("wtile", [None, 256])
def test_extend_and_select_tokens(wtile):
    """extend_runs + select_tokens on seeded matches, both cell widths."""
    rng = np.random.default_rng(7)
    s, b = 4096, 3
    ml = rng.choice([0, 0, 4, 5, 8, 16], size=(b, s)).astype(np.int32)
    dist = rng.integers(1, 64, (b, s)).astype(np.int32)
    run = rng.random((b, s)) < 0.5                # same-distance runs
    dist[:, 1:][run[:, 1:]] = dist[:, :-1][run[:, 1:]]
    valid = np.array([s, s - 100, 1234], np.int32)

    def ref(m, d, v):
        m = jev.extend_runs(m, d, v)
        return (m,) + jev.select_tokens(m, d, v, wtile=wtile)

    want = jax.jit(jax.vmap(ref))(jnp.asarray(ml), jnp.asarray(dist),
                                  jnp.asarray(valid))
    ml_t, dist_t, v_t = (torch.from_numpy(x) for x in (ml, dist, valid))
    ext = pev.extend_runs(ml_t.long(), dist_t.long(), v_t)
    got = (ext,) + pev.select_tokens(ext, dist_t.long(), v_t, wtile=wtile)
    for g, w in zip(got, want):
        eq(g, w)


def test_pack_rows_direct_placement():
    """pack_rows' integer bit placement equals the JAX one-hot einsum."""
    rng = np.random.default_rng(9)
    b, s = 2, 1024
    nb = rng.integers(0, 29, (b, s)).astype(np.int32)
    val = (rng.integers(0, 1 << 31, (b, s)) & ((1 << nb) - 1)).astype(
        np.uint32)
    start = np.array([3, 77], np.int32)
    want = jax.jit(jax.vmap(lambda v, n, st: jev.pack_rows(v, n, st, 64)))(
        jnp.asarray(val), jnp.asarray(nb), jnp.asarray(start))
    got = pev.pack_rows(torch.from_numpy(val.astype(np.int64)),
                        torch.from_numpy(nb), torch.from_numpy(start), 64)
    for g, w in zip(got, want):
        eq(g, w)


# ------------------------------------------------------ analyze and emit
def _blocks(kind):
    data = make_corpus(kind, 40000, seed=3)
    return data, pgd.split_blocks_hist(data, BLOCK)


@pytest.fixture(scope="module")
def analyzed():
    """Per kind: (data, blocks, JAX analyze outputs, port outputs)."""
    out = {}
    for kind in KINDS:
        data, (arr, valid, hs, finals, num) = _blocks(kind)
        assert hs[0] == ped.HIST and hs[-1] == 0     # first block: no history
        want = jed.jit_analyze_l6(BLOCK)(jnp.asarray(arr), jnp.asarray(valid),
                                         jnp.asarray(hs))
        got = ped.analyze_block_l6(torch.from_numpy(arr),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(hs), BLOCK)
        out[kind] = (data, (arr, valid, hs, finals, num),
                     [np.asarray(w) for w in want], got)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_analyze_block_l6_equals_jax(kind, analyzed):
    _, _, want, got = analyzed[kind]
    names = ("ml", "dist", "sel", "lit", "ll_hist", "of_hist")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        eq(g, w)
    assert got[4].dtype == torch.uint16 and got[5].dtype == torch.uint16


@pytest.mark.parametrize("kind", KINDS)
def test_emit_pack_equals_jax_given_same_tables(kind, analyzed):
    _, (arr, _, _, finals, _), want, got = analyzed[kind]
    ll, of, hdrs, hb = jed.build_tables_host(want[4], want[5], finals)
    pll, pof, phdrs, phb = ped.build_tables_host(got[4], got[5], finals)
    eq(pll, ll)
    eq(pof, of)
    eq(phb, hb)
    assert phdrs == hdrs
    ref = jed.jit_emit(BLOCK)(
        jnp.asarray(arr)[:, ped.HIST:], *(jnp.asarray(w) for w in want[:4]),
        jnp.asarray(ll), jnp.asarray(of), jnp.asarray(hb))
    mine = ped.emit_pack(
        torch.from_numpy(arr)[:, ped.HIST:], *got[:4],
        torch.from_numpy(ll.astype(np.int64)),
        torch.from_numpy(of.astype(np.int64)),
        torch.from_numpy(hb.astype(np.int64)), BLOCK)
    for g, w in zip(mine, ref):
        eq(g, w)


def test_deflate_device_l6_many_bytes_equal_jax():
    datas = [make_corpus(k, 30000 + 997 * i, seed=i)
             for i, k in enumerate(KINDS)] + [b"", b"x"]
    want = jgd.deflate_device_l6_many(datas, BLOCK)
    got = pgd.deflate_device_l6_many(datas, BLOCK, device="cpu")
    assert got == want
    for d, o in zip(datas, got):
        assert zlib.decompress(o, -15) == d
    assert pgd.deflate_device_l6(datas[0], BLOCK, device="cpu") == got[0]


def test_window_guard_raises():
    with pytest.raises(ValueError):
        pgd.deflate_device_l6(b"x" * 200000, 131072, device="cpu")
