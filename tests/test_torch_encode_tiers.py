"""The level 0-5 device compress tiers: the port's PyTorch functions
against the JAX package's on the CPU, on seeded inputs. Tolerance: exact
equality (the outputs are integers and bytes).

Block size 16384 is the one tests/test_device_encoder.py and
tests/test_device_dynamic.py compile. The JAX model functions are called
directly (not through the JAX BatchCompressor, whose broad except could
hide a host-path result)."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu import batch as jbatch
from libdeflate_rsx_tpu.models import greedy_dynamic as jgd
from libdeflate_rsx_tpu.models import greedy_static as jgs
from libdeflate_rsx_tpu.models import stored as jst
from libdeflate_rsx_tpu.ops import encode_dynamic as jed
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu_torch import BatchCompressor
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as pgd
from libdeflate_rsx_tpu_torch.models import greedy_static as pgs
from libdeflate_rsx_tpu_torch.models import stored as pst
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import encode_v2 as pev
from tests.conftest import make_corpus

torch.set_num_threads(2)
BLOCK = 16384
KINDS = ("text", "pattern", "random", "zeros", "periodic:7")


def eq(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.fixture(scope="module")
def blocks():
    """Per kind: 40,000 seeded bytes split into blocks of BLOCK (the last
    one short), as numpy and as CPU tensors."""
    out = {}
    for kind in KINDS:
        data = make_corpus(kind, 40000, seed=3)
        arr, valid, finals, num = pgs.split_blocks(data, BLOCK)
        out[kind] = (data, (arr, valid, finals, num),
                     tuple(torch.from_numpy(x) for x in (arr, valid, finals)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_find_matches_v2_equals_jax(kind, blocks):
    _, (arr, valid, _, _), (arr_t, valid_t, _) = blocks[kind]
    want = jax.jit(jax.vmap(functools.partial(
        jev.find_matches_v2, block_size=BLOCK)))(jnp.asarray(arr),
                                                 jnp.asarray(valid))
    got = pev.find_matches_v2(arr_t, valid_t, BLOCK)
    for g, w in zip(got, want):
        eq(g, w)
    assert int(got[0].max()) <= pev.MAX_VEC_ML


@pytest.fixture(scope="module")
def static_rows(blocks):
    """Per kind: the JAX and the port encode_rows_static outputs."""
    out = {}
    for kind in KINDS:
        _, (arr, valid, finals, _), args = blocks[kind]
        want = jev.jit_encoder(BLOCK)(jnp.asarray(arr), jnp.asarray(valid),
                                      jnp.asarray(finals))
        out[kind] = ([np.asarray(w) for w in want],
                     pev.encode_rows_static(*args, BLOCK))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_encode_rows_static_equals_jax(kind, static_rows):
    want, got = static_rows[kind]
    for name, g, w in zip(("rows", "byte_off", "rowbits", "total_bits",
                           "nbytes"), got, want):
        assert g.shape == w.shape, name
        eq(g, w)
    assert got[0].dtype == torch.uint8


@pytest.mark.parametrize("kind", KINDS)
def test_assemble_blocks_equals_jax(kind, blocks, static_rows):
    """The port's row placement of its rows (ops/assemble.place_rows,
    the plain version on the CPU) equals the JAX package's of its rows
    (the numpy path: its native assembly does not build), and every
    block decodes."""
    from libdeflate_rsx_tpu_torch.ops.assemble import place_rows, static_layout

    data, (_, _, finals, num), _ = blocks[kind]
    want, got = static_rows[kind]
    out_cap = int(BLOCK * 1.25) + 64
    fin = torch.from_numpy(finals)
    out, nbytes = place_rows(got[0], got[1],
                             *static_layout(got[2], got[3], fin), fin,
                             out_cap)
    eq(nbytes, want[4])
    parts = [out[i, :int(nbytes[i])].numpy().tobytes() for i in range(num)]
    rows, off, bits, total, nb = want
    assert parts == jev.assemble_blocks(
        np.asarray(rows), np.asarray(off).astype(np.int64),
        np.asarray(bits).astype(np.int64), np.asarray(total),
        np.asarray(nb), finals, num, out_cap)
    assert zlib.decompress(b"".join(parts), -15) == data


@pytest.mark.parametrize("size", [0, 1, 65535, 65536, 200000])
def test_deflate_device_stored_equals_jax(size):
    data = make_corpus("random", size)
    got = pst.deflate_device_stored(data, device="cpu")
    assert got == jst.deflate_device_stored(data)
    assert zlib.decompress(got, -15) == data
    assert len(got) == size + 5 * max(1, -(-size // pst.STORED_BLOCK))


@pytest.mark.parametrize("kind,size", [
    ("text", 70000), ("random", 30000), ("text", 0), ("text", 1),
    ("text", 65537)])
def test_deflate_device_static_default_block_equals_jax(kind, size):
    data = make_corpus(kind, size)
    got = pgs.deflate_device_static(data, device="cpu")
    assert got == jgs.deflate_device_static(data)
    assert zlib.decompress(got, -15) == data
    if kind == "random":                  # the stored fallback
        assert len(got) == size + 5 and got[0] == 1


def test_deflate_device_static_launch_rows_equals_jax():
    """The JAX package's unrolled-launch case (41 blocks in sub-batches
    of launch_rows); the port's passes of 4 blocks give the bytes of one
    pass."""
    data = make_corpus("pattern", 40 * BLOCK + 123)
    got = pgs.deflate_device_static(data, BLOCK, launch_rows=4, device="cpu")
    assert got == jgs.deflate_device_static(data, BLOCK, launch_rows=4)
    assert got == pgs.deflate_device_static(data, BLOCK, device="cpu")
    assert zlib.decompress(got, -15) == data


def test_deflate_device_static_v2_equals_jax(blocks):
    data = blocks["text"][0]
    got = pev.deflate_device_static_v2(data, BLOCK, device="cpu")
    assert got == jev.deflate_device_static_v2(data, BLOCK)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("kind", KINDS)
def test_analyze_block_equals_jax(kind, blocks):
    _, (arr, valid, _, _), (arr_t, valid_t, _) = blocks[kind]
    want = jed.jit_analyze(BLOCK)(jnp.asarray(arr), jnp.asarray(valid))
    got = ped.analyze_block(arr_t, valid_t, BLOCK)
    for name, g, w in zip(("ml", "dist", "sel", "lit", "ll_hist",
                           "of_hist"), got, want):
        assert g.shape == w.shape, name
        eq(g, w)
    assert got[4].dtype == torch.uint16 and got[5].dtype == torch.uint16


def test_deflate_device_dynamic_equals_jax():
    datas = [make_corpus(k, 30000 + 997 * i, seed=i)
             for i, k in enumerate(KINDS)] + [b"", b"x",
                                              make_corpus("random", 80000)]
    want = jgd.deflate_device_dynamic_many(datas, BLOCK)
    got = pgd.deflate_device_dynamic_many(datas, BLOCK, device="cpu")
    assert got == want
    for d, o in zip(datas, got):
        assert zlib.decompress(o, -15) == d
        assert pgd.deflate_device_dynamic(d, BLOCK, device="cpu") == o
    assert got[0] == jgd.deflate_device_dynamic(datas[0], BLOCK)
    # random data: every block falls back to one stored block
    assert len(got[-1]) == len(datas[-1]) + 5 * -(-len(datas[-1]) // BLOCK)


# ------------------------------------------------------------ batch surface
DATAS = [make_corpus("text", 70000, seed=1), make_corpus("pattern", 9000),
         make_corpus("random", 3000, seed=2), b"", b"x"]
_JAX_MODEL = {0: jst.deflate_device_stored, 1: jgs.deflate_device_static,
              2: jgs.deflate_device_static, 3: jgs.deflate_device_static,
              4: jgd.deflate_device_dynamic, 5: jgd.deflate_device_dynamic}


@functools.lru_cache(maxsize=None)
def _jax_payloads(level: int) -> tuple:
    return tuple(_JAX_MODEL[level](d) for d in DATAS)


@pytest.mark.parametrize("fmt", ["deflate", "zlib", "gzip"])
@pytest.mark.parametrize("level", range(6))
def test_batch_compressor_levels_0_5_equal_jax_tiers(level, fmt):
    """BatchCompressor(level, use_device=True, device="cpu") gives the
    JAX tier's model output in the JAX package's framing."""
    jbc = jbatch.BatchCompressor(level=level, format=fmt)
    want = [jbc._frame(d, p) for d, p in zip(DATAS, _jax_payloads(level))]
    bc = BatchCompressor(level=level, format=fmt, use_device=True,
                         device="cpu")
    assert bc.compress_batch(DATAS) == want
    assert bc.compress_batch(DATAS[:1]) == want[:1]      # one item alone


def test_batch_compressor_level0_auto_needs_no_sample():
    bc = BatchCompressor(level=0, device="cpu")
    assert bc._ratio_calibrate([b"x"]) is True and bc._ratio_ok is True


def test_device_levels_default_to_the_card():
    """use_device=True without device= means the card, at every device
    level: without one the batch raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for level in range(6):
        bc = BatchCompressor(level=level, use_device=True)
        assert bc.device.type == "cuda"
        with pytest.raises((RuntimeError, AssertionError)):
            bc.compress_batch([DATAS[1], DATAS[2]])
