"""The port's own host layer (a copy of the JAX package's JAX-free host
modules, without the native codec) against the JAX package on the CPU:
the same compressed bytes at every level and format, the same decoded
bytes and errors, the same streams, and checksums equal to zlib's."""

import io
import zlib

import pytest

import libdeflate_rsx_tpu as ref
import libdeflate_rsx_tpu_torch as port
from libdeflate_rsx_tpu.utils import errors as ref_errors
from libdeflate_rsx_tpu_torch.utils import errors as port_errors
from tests.conftest import make_corpus

KINDS = ["text", "random", "pattern", "zeros", "periodic:7"]
FORMATS = ["deflate", "zlib", "gzip"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", list(range(10)) + [12])
def test_compressor_bytes_equal(level, kind):
    data = make_corpus(kind, 4096 if level == 12 else 6000, seed=level)
    for fmt in FORMATS:
        got = getattr(port.Compressor(level), "compress_" + fmt)(data)
        want = getattr(ref.Compressor(level), "compress_" + fmt)(data)
        assert got == want, fmt


def test_chunked_compress_over_256k_equal():
    """Inputs over 256 KiB compress as SYNC-joined chunks on the host
    pool in both packages (the port on its own pool)."""
    data = make_corpus("text", 300 << 10, seed=3)
    got = port.Compressor(1).compress_deflate(data)
    assert got == ref.Compressor(1).compress_deflate(data)
    assert zlib.decompress(got, -15) == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_decompressor_round_trip(fmt):
    data = make_corpus("text", 20000, seed=4)
    comp = getattr(ref.Compressor(6), "compress_" + fmt)(data)
    got = getattr(port.Decompressor(), "decompress_" + fmt)(comp, len(data))
    assert got == data


def _error_name(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the class is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("case", ["truncated", "corrupt", "small_out",
                                  "bad_header", "limit"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_decompressor_errors_match(fmt, case):
    data = make_corpus("text", 5000, seed=5)
    comp = getattr(ref.Compressor(6), "compress_" + fmt)(data)
    max_out = len(data)
    if case == "truncated":
        comp = comp[: len(comp) // 2]
    elif case == "corrupt":
        comp = comp[:-1] + bytes([comp[-1] ^ 0x55])
    elif case == "small_out":
        max_out = 100
    elif case == "bad_header":
        comp = b"\x07" + comp[1:]
    names = []
    for pkg in (port, ref):
        d = pkg.Decompressor()
        if case == "limit":
            d.set_max_memory_limit(10)
        names.append(_error_name(
            lambda: getattr(d, "decompress_" + fmt)(comp, max_out)))
    assert names[0] == names[1]
    if case != "bad_header" or fmt != "deflate":
        assert names[0] is not None
        assert hasattr(port_errors, names[0]) and hasattr(ref_errors, names[0])


@pytest.mark.parametrize("level", [0, 1, 6])
def test_stream_encoders_equal(level):
    data = make_corpus("text", 50000, seed=6)
    outs = []
    for pkg in (port, ref):
        raw, gz = io.BytesIO(), io.BytesIO()
        enc = pkg.DeflateEncoder(raw, level, buffer_size=16384)
        genc = pkg.GzipEncoder(gz, level, buffer_size=16384)
        for k in range(0, len(data), 7000):
            enc.write(data[k:k + 7000])
            genc.write(data[k:k + 7000])
            if k == 21000:
                enc.flush()
                genc.new_member()
        enc.finish()
        genc.finish()
        outs.append((raw.getvalue(), gz.getvalue()))
    assert outs[0] == outs[1]
    assert zlib.decompress(outs[0][0], -15) == data


@pytest.mark.parametrize("size", [0, 100, 5000])
def test_stream_decoders_equal(size):
    data = make_corpus("pattern", 40000, seed=7)
    raw = ref.Compressor(6).compress_deflate(data)
    gz = ref.Compressor(6).compress_gzip(data) * 2
    for pkg_out in [(pkg.DeflateDecoder(io.BytesIO(raw)),
                     pkg.GzipDecoder(io.BytesIO(gz))) for pkg in (port, ref)]:
        dec, gdec = pkg_out
        if size:
            got = b"".join(iter(lambda: dec.read(size), b""))
            ggot = b"".join(iter(lambda: gdec.read(size), b""))
        else:
            got, ggot = dec.read(), gdec.read()
        assert got == data and ggot == data * 2


def test_deflater_equal():
    data = make_corpus("text", 30000, seed=8)
    outs = []
    for pkg in (port, ref):
        d = pkg.Deflater(6)
        outs.append(d.compress(data[:10000]) + d.compress(data[10000:20000])
                    + d.compress(data[20000:], pkg.engine.Flush.FINISH))
    assert outs[0] == outs[1]
    assert zlib.decompress(outs[0], -15) == data


@pytest.mark.parametrize("kind", KINDS)
def test_checksums_equal_zlib(kind):
    data = make_corpus(kind, 70001, seed=9)
    assert port.crc32(data) == zlib.crc32(data)
    assert port.adler32(data) == zlib.adler32(data)
    assert port.crc32(data[1000:], port.crc32(data[:1000])) == zlib.crc32(data)
    assert port.adler32(bytearray(data)) == ref.adler32(data)


def test_public_surface_matches():
    assert set(port.__all__) == set(ref.__all__)
    assert port.errors.DeflateError.__name__ == ref.errors.DeflateError.__name__
