"""The port's examples (examples/torch_*.py) run to their end on the CPU
and print what the JAX package's examples print.

- basics, batch, streaming, checksums: run in this process (runpy)
  beside the JAX example of the same name; stdout equal line for line
  (neither touches a device path on the CPU).
- gzip_zlib (it compresses its own file) and manual_bench (it prints
  times): the lines have the JAX example's shape, numbers aside.
- device_tiers, sharded and multihost_global with --device cpu, each as
  its own process (the two distributed ones start 2 gloo ranks), all
  started together by the first test that needs them; each must exit 0.
  The tier sizes device_tiers prints equal the JAX tiers' on the same
  text.
"""

import os
import pathlib
import re
import runpy
import signal
import subprocess
import sys
import zlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
PROCESS_EXAMPLES = ("torch_device_tiers", "torch_sharded",
                    "torch_multihost_global")
TIMEOUT = 420       # seconds for each example process

torch.set_num_threads(2)


def run_here(path: pathlib.Path, capsys, monkeypatch, *args) -> list[str]:
    """Run an example in this process; its stdout lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [str(path), *args])
    runpy.run_path(str(path), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def shape(line: str) -> str:
    """A line with every number as # and runs of spaces as one."""
    return re.sub(r" +", " ", re.sub(r"\d+(\.\d+)?", "#", line))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The device examples with --device cpu, each a process started
    now; every one still running at the module's end is killed."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, OMP_NUM_THREADS="2", LIBDEFLATE_RSX_THREADS="2")
    procs = {}
    for name in PROCESS_EXAMPLES:
        out = open(tmp / f"{name}.out", "w+")
        err = open(tmp / f"{name}.err", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(EXAMPLES / f"{name}.py"), "--device",
             "cpu"], cwd=tmp, env=env, stdout=out, stderr=err, text=True,
            start_new_session=True), out, err)
    yield procs
    for p, out, err in procs.values():
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        out.close()
        err.close()


def finished(launched, name: str) -> list[str]:
    """Wait for an example process (killed with its ranks past TIMEOUT);
    it must exit 0. Its stdout lines."""
    p, out, err = launched[name]
    try:
        p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    err.seek(0)
    assert p.returncode == 0, f"{name}: exit {p.returncode}\n" \
        f"{err.read()[-4000:]}"
    out.seek(0)
    return out.read().splitlines()


def test_device_tiers_sizes_equal_the_jax_tiers(launched):
    from libdeflate_rsx_tpu.batch import BatchCompressor
    from libdeflate_rsx_tpu.models.greedy_dynamic import (
        deflate_device_dynamic)
    from libdeflate_rsx_tpu.models.greedy_static import (
        deflate_device_static)

    # examples/device_tiers.py's text, as examples/torch_device_tiers.py
    text = (b"the dynamic tier builds one Huffman code per 64 KiB block, "
            b"so entropy-skewed data like this sentence compresses harder. "
            ) * 3000
    static = deflate_device_static(text)
    dynamic = deflate_device_dynamic(text)
    frames = BatchCompressor(level=6, format="gzip", use_device=True) \
        .compress_batch([text, text[::-1]])
    chunks = [text[i:i + 65536 - 1024]
              for i in range(0, len(text), 65536)][:4]
    want = [f"input {len(text)} B -> static tier {len(static)} B "
            f"({len(text) / len(static):.2f}x), dynamic tier "
            f"{len(dynamic)} B ({len(text) / len(dynamic):.2f}x)",
            f"batch gzip: {[len(f) for f in frames]} bytes",
            f"device batch decode: {len(chunks)} streams, "
            f"{sum(map(len, chunks))} bytes, byte-exact"]
    assert zlib.decompress(static, -15) == text
    assert finished(launched, "torch_device_tiers") == want


@pytest.mark.parametrize("name", ["basics", "batch", "streaming",
                                  "checksums"])
def test_host_example_prints_the_jax_lines(name, capsys, monkeypatch):
    got = run_here(EXAMPLES / f"torch_{name}.py", capsys, monkeypatch)
    want = run_here(EXAMPLES / f"{name}.py", capsys, monkeypatch)
    assert got and got == want


def test_gzip_zlib_lines_have_the_jax_shape(capsys, monkeypatch):
    got = run_here(EXAMPLES / "torch_gzip_zlib.py", capsys, monkeypatch)
    want = run_here(EXAMPLES / "gzip_zlib.py", capsys, monkeypatch)
    assert [shape(x) for x in got] == [shape(x) for x in want] == \
        ["gzip: # bytes, zlib: # bytes", "cross-interop OK"]


def test_manual_bench_lines_have_the_jax_shape(capsys, monkeypatch):
    """The JAX example's prints (examples/manual_bench.py: `level
    {level}: {MB/s:8.1f} MB/s ratio {ratio:6.1f}x` for levels 1, 6 and 9,
    then `decompress: {MB/s:8.1f} MB/s`); it runs at 4 MiB, the port's at
    a --size of 64 KiB here."""
    got = run_here(EXAMPLES / "torch_manual_bench.py", capsys, monkeypatch,
                   "--size", "65536")
    assert [shape(x) for x in got] == \
        ["level #: # MB/s ratio #x"] * 3 + ["decompress: # MB/s"]
    assert [x.split(":")[0] for x in got] == \
        ["level 1", "level 6", "level 9", "decompress"]


def test_sharded_example_two_ranks(launched):
    lines = finished(launched, "torch_sharded")
    assert lines[0] == "mesh: 2 ranks on axis 'streams'"
    assert [shape(x) for x in lines[1:3]] == \
        ["gzip: # -> # bytes across the ranks",
         "batch sizes: [#, #, #]"]
    assert lines[3:5] == ["sharded decode: 6 streams OK",
                          "sharded decode (device resolve): 6 streams OK"]
    assert lines[5].endswith("across 2 ranks")


def test_multihost_global_example_two_ranks(launched):
    lines = finished(launched, "torch_multihost_global")
    assert shape(lines[0]).startswith("global gzip container: # -> # bytes")
    assert lines[1].startswith("2 ranks emitted the same container")
