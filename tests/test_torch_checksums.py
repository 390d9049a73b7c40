"""The device checksums: the port's integer CRC-32 and Adler-32 against
zlib and against the JAX package's functions, on the CPU, at the sizes,
initial values, odd chunk counts and empty input of
tests/test_device_checksums.py. Tolerance: exact equality."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.ops import checksums as jck
from libdeflate_rsx_tpu_torch.ops import adler32_device, crc32_device
from libdeflate_rsx_tpu_torch.ops import checksums as pck
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
    assert int(pck.crc32_fixed(torch.zeros(1024, dtype=torch.uint8), 0,
                               77)) == 77
    assert int(pck.adler32_fixed(torch.zeros(128, dtype=torch.uint8), 0,
                                 99)) == 99


@pytest.mark.parametrize("length", [1, 1000, 3071, 3072])
def test_fixed_equals_jax_on_padded_rows(length):
    """crc32_fixed and adler32_fixed on one zero-padded row of 3 KiB,
    with an initial value, equal the JAX functions."""
    row = np.zeros(3072, np.uint8)
    row[:length] = np.frombuffer(make_corpus("text", length, seed=length),
                                 np.uint8)
    t, j = torch.from_numpy(row), jnp.asarray(row)
    assert int(pck.crc32_fixed(t, length, 0xDEADBEEF)) == \
        int(jck.crc32_fixed(j, length, 0xDEADBEEF)) == \
        zlib.crc32(row[:length].tobytes(), 0xDEADBEEF)
    assert int(pck.adler32_fixed(t, length, 0x12345678 % 65521)) == \
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
    crcs = pck.crc32_blocks(*args).numpy()
    adlers = pck.adler32_blocks(*args).numpy()
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
