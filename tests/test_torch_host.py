"""The port's own host layer (a copy of the JAX package's JAX-free host
modules, without the native codec) against the JAX package on the CPU:
the same compressed bytes at every level and format, the same decoded
bytes and errors, the same streams, and checksums equal to zlib's."""

import ast
import importlib
import io
import pathlib
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


REF_ROOT = pathlib.Path(ref.__file__).parent
#: JAX-package modules whose port lives at another path
MOVED = {"ops.pallas": "ops",
         "ops.pallas.inflate_tokens": "ops.inflate_tokens",
         "ops.pallas.inflate_v2": "ops.inflate_v2",
         "ops.pallas.inflate_static": "ops.inflate_static",
         "parallel.hostpool": "hostpool"}
_JIT = (None, "an XLA compile cache, a TPU artifact", "ROADMAP item 17")
_NATIVE = (None, "the native host tier, which does not build (fault 3.1); "
           "the port runs the Python host paths", "ROADMAP items 17-18")
_ASSEMBLE = ("ops.assemble:assemble", "the row assembly, stored fallback "
             "included, is csrc/assemble_rows.cu", "ROADMAP items 19-21")
#: the only JAX-package public names without a counterpart of the same
#: name in the port's module of the same path: (module, name) ->
#: (the port's counterpart "module:name" or None, why, where the ROADMAP
#: says so)
NOT_PORTED = {
    ("models.greedy_dynamic", "assemble_dynamic"): _ASSEMBLE,
    ("models.greedy_dynamic", "apply_stored_fallback"): _ASSEMBLE,
    ("models.greedy_static", "assemble_with_fallback"): _ASSEMBLE,
    ("ops.encode_v2", "assemble_blocks"): _ASSEMBLE,
    ("ops.encode_v2", "jit_encoder"): _JIT,
    ("ops.encode_v2", "jit_encoder_scan"): _JIT,
    ("ops.encode_dynamic", "jit_analyze_l6"): _JIT,
    ("ops.encode_dynamic", "jit_analyze"): _JIT,
    ("ops.encode_dynamic", "jit_emit"): _JIT,
    ("ops.encode_dynamic", "find_matches_l6"): (
        "ops.match_l6:find_matches_l6", "the match kernel's dispatcher; "
        "the plain graph is encode_dynamic.find_matches_l6_plain",
        "ROADMAP item 22"),
    ("ops.pallas.inflate_tokens", "steps_for_caps"): (
        None, "the pass-1 step budget, a TPU artifact", "ROADMAP item 17"),
    ("ops.resolve", "resolve_batch_jax"): (
        "ops.resolve:resolve_batch_plain", "the JAX graph in plain "
        "PyTorch; csrc/resolve.cu runs in its place on the card",
        "ROADMAP section 2b"),
    ("parallel.hostpool", "get_pool"): (
        "hostpool:_get_pool", "private in the port: only pmap uses it",
        "ROADMAP item 16"),
    ("native", "get_ext"): _NATIVE,
    ("native", "get_lib"): _NATIVE,
    ("native", "dyn_tables_native"): (
        "ops.dyn_tables:build_tables", "the table builder is "
        "csrc/dyn_tables.cu", "ROADMAP section 2c"),
    ("native", "assemble_rows_native"): _ASSEMBLE,
    ("native.host", "native_available"): _NATIVE,
    ("native.host", "native_deflate"): _NATIVE,
    ("native.host", "native_deflate_bits"): _NATIVE,
    ("native.host", "native_inflate"): _NATIVE,
    ("native.host", "native_crc32"): _NATIVE,
    ("native.host", "native_adler32"): _NATIVE,
    ("native.host", "CInflater"): _NATIVE,
    ("native.host", "native_resolve_tokens"): (
        "ops.resolve:resolve_batch", "LZ resolution is csrc/resolve.cu",
        "ROADMAP section 2c"),
}
REF_MODULES = sorted(
    ".".join(p.relative_to(REF_ROOT).with_suffix("").parts)
    .removesuffix("__init__").rstrip(".")
    for p in REF_ROOT.rglob("*.py"))


def public_defs(module: str) -> list[str]:
    """The public functions and classes a JAX-package module defines
    (read from its source: importing it would import JAX)."""
    parts = module.split(".") if module else []
    path = REF_ROOT.joinpath(*parts)
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def port_module(module: str):
    """The port's module at the JAX module's path (or where MOVED puts
    it), or None when the port has no such module."""
    name = ".".join(filter(None, ["libdeflate_rsx_tpu_torch",
                                  MOVED.get(module, module)]))
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if not name.startswith(e.name):
            raise
        return None


def counterpart(spec: str):
    module, name = spec.split(":")
    return getattr(importlib.import_module(
        "libdeflate_rsx_tpu_torch." + module), name)


@pytest.mark.parametrize("module", REF_MODULES)
def test_every_public_name_has_a_counterpart(module):
    """Every public function and class of every JAX-package module is in
    the port's module of the same path, or in NOT_PORTED, whose entries
    all name a reason, a ROADMAP place and, where there is one, a
    counterpart that exists; no entry of NOT_PORTED is stale."""
    mod = port_module(module)
    missing = {n for n in public_defs(module)
               if mod is None or not hasattr(mod, n)}
    listed = {n for m, n in NOT_PORTED if m == module}
    assert missing == listed
    for n in listed:
        spec, why, where = NOT_PORTED[module, n]
        assert why and where.startswith("ROADMAP")
        assert spec is None or callable(counterpart(spec))


def test_surface_table_covers_only_real_modules():
    assert len(REF_MODULES) == 38 and "" in REF_MODULES
    assert {m for m, _ in NOT_PORTED} <= set(REF_MODULES)
    assert set(MOVED) <= set(REF_MODULES)
