"""The port's `utils.profiling` held to the JAX package's: `trace` prints
the same line under LIBDEFLATE_TPU_TRACE and nothing without it, and
`device_trace` writes a trace file that holds the span."""

import json
import re

import torch

from libdeflate_rsx_tpu.utils import profiling as jax_profiling
from libdeflate_rsx_tpu_torch.utils import profiling

torch.set_num_threads(2)

_LINE = re.compile(r"^\[trace\] (\S+): \d+\.\d\d ms$")


def traced(mod, name: str, capsys) -> str:
    with mod.trace(name):
        torch.arange(1000).sum()
    return capsys.readouterr().out


def test_trace_prints_the_jax_line(monkeypatch, capsys):
    monkeypatch.setenv("LIBDEFLATE_TPU_TRACE", "1")
    got = traced(profiling, "l6_item", capsys).splitlines()
    want = traced(jax_profiling, "l6_item", capsys).splitlines()
    assert len(got) == len(want) == 1
    assert _LINE.match(got[0]).group(1) == \
        _LINE.match(want[0]).group(1) == "l6_item"


def test_trace_is_silent_without_the_variable(monkeypatch, capsys):
    monkeypatch.delenv("LIBDEFLATE_TPU_TRACE", raising=False)
    assert traced(profiling, "quiet", capsys) == ""
    assert traced(jax_profiling, "quiet", capsys) == ""


def test_device_trace_writes_the_span(tmp_path, capsys):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        with profiling.trace("l6_item"):
            torch.ones(64).cumsum(0)
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "l6_item" for e in events)
