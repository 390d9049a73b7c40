"""The PyTorch port imports torch and never jax, nor anything of the JAX
package: it keeps its own copy of the host layer. Its pass-1 wrapper
keeps to its device rules."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "libdeflate_rsx_tpu_torch"
SOURCES = sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
_JAX_IMPORT = re.compile(r"^\s*(import jax|from jax)\b", re.M)
# the JAX package by name (libdeflate_rsx_tpu_torch does not match: \b)
_REF_IMPORT = re.compile(r"^\s*(import|from)\s+libdeflate_rsx_tpu\b", re.M)

torch.set_num_threads(2)


def test_import_leaves_jax_out():
    mods = ["libdeflate_rsx_tpu_torch"] + [
        "libdeflate_rsx_tpu_torch." + p[len("libdeflate_rsx_tpu_torch/"):-3]
        .replace("/", ".").replace(".__init__", "")
        for p in SOURCES if not p.endswith("torch/__init__.py")]
    # every module, then the host paths: a compress over 256 KiB (the
    # chunked path on the host pool), a decompress, the stream classes
    # and a batch decode on the host
    code = ("import importlib, io, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import libdeflate_rsx_tpu_torch as t\n"
            "data = bytes(range(251)) * 1224 + b'tail' * 9000\n"
            "assert len(data) > 256 << 10\n"
            "c = t.Compressor(6).compress_zlib(data)\n"
            "assert t.Decompressor().decompress_zlib(c, len(data)) == data\n"
            "buf = io.BytesIO()\n"
            "enc = t.DeflateEncoder(buf, 1, buffer_size=1 << 16)\n"
            "enc.write(data[:100000]); enc.finish()\n"
            "out = t.DeflateDecoder(io.BytesIO(buf.getvalue())).read()\n"
            "assert out == data[:100000]\n"
            "bd = t.BatchDecompressor('zlib', use_device=True, device='cpu')\n"
            "assert bd.decompress_batch([c, b'x'], [len(data), 9]) == \\\n"
            "    [data, None]\n"
            "assert dict(bd.fallbacks) == {'out_cap': 1, 'container': 1}\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
            "             or m.split('.')[0] == 'libdeflate_rsx_tpu')\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, LIBDEFLATE_RSX_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


PROBES = ["scripts/pass1_probe.py", "scripts/stream_probe.py",
          "scripts/phase_probe_torch.py", "scripts/resolve_probe.py",
          "scripts/match_probe.py", "scripts/select_probe.py"]
EXAMPLES = sorted(str(p.relative_to(ROOT))
                  for p in (ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", SOURCES + ["chip_smoke.py",
                                            "tests/_port_corpus.py"]
                         + PROBES + EXAMPLES)
def test_no_jax_import_in_sources(path):
    text = (ROOT / path).read_text()
    assert not _JAX_IMPORT.search(text), path


@pytest.mark.parametrize("path", SOURCES + ["chip_smoke.py"] + PROBES
                         + EXAMPLES)
def test_no_jax_package_import_in_sources(path):
    text = (ROOT / path).read_text()
    assert not _REF_IMPORT.search(text), path


def test_every_jax_example_has_a_port_example():
    """Each JAX example `examples/<name>.py` has its port beside it,
    `examples/torch_<name>.py`."""
    jax_examples = sorted(p.name for p in (ROOT / "examples").glob("*.py")
                          if not p.name.startswith("torch_"))
    assert len(jax_examples) == 9
    assert EXAMPLES == [f"examples/torch_{n}" for n in jax_examples]


def test_chip_smoke_drives_only_the_port():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from) libdeflate_rsx_tpu\b", text,
                         re.M)
    assert "libdeflate_rsx_tpu_torch" in text


@pytest.mark.parametrize("kind", ["text", "random", "pattern", "zeros",
                                  "periodic:7"])
def test_chip_smoke_corpus_equals_the_tests(kind):
    """The JAX-free make_corpus that chip_smoke.py uses gives the same
    bytes as the suite's."""
    from _port_corpus import make_corpus as smoke_corpus
    from tests.conftest import make_corpus

    assert smoke_corpus(kind, 5000, seed=4) == make_corpus(kind, 5000, seed=4)
    assert smoke_corpus(kind, 300) == make_corpus(kind, 300)


def test_pass1_wrapper_rules():
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    data, offs, lens, ok = it.pack_streams([b"\x03\x00"], 65536, "cpu")
    with pytest.raises(ValueError):
        it.pass1(data.to(torch.int32), offs, lens, 64)
    with pytest.raises(ValueError):
        it.pass1(data, offs.to(torch.int32), lens, 64)
    with pytest.raises(ValueError):
        it.pass1(data, offs, lens, 0)
    with pytest.raises(ValueError):
        it.pass1(data.to("meta"), offs.to("meta"), lens.to("meta"), 64)
    before = it.LAUNCHES
    tokens, stats = it.pass1(data, offs, lens, 64)
    assert it.LAUNCHES == before          # a CPU tensor takes the plain path
    assert stats.tolist() == [[it.DONE, 0, 10, 0]]
    assert tokens.shape == (1, 64) and not tokens.any()
