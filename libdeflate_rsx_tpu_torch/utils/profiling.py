"""Profiling hooks: wall-clock spans that also show in torch.profiler
traces, and a whole-region trace written as a Chrome trace file.

Port of `libdeflate_rsx_tpu/utils/profiling.py`, where the spans are
`jax.profiler.TraceAnnotation`s and the region trace is
`jax.profiler.trace`.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(name: str):
    """Wall-clock span; also a `torch.profiler.record_function` span, so
    that it shows in torch.profiler traces. Under LIBDEFLATE_TPU_TRACE
    it prints `[trace] {name}: {ms} ms` when the span ends."""
    t0 = time.perf_counter()
    with record_function(name):
        yield
    dt = time.perf_counter() - t0
    if os.environ.get("LIBDEFLATE_TPU_TRACE"):
        print(f"[trace] {name}: {dt * 1000:.2f} ms")


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Trace a region with torch.profiler, CPU activity always and CUDA
    activity unless device is "cpu" (default: cuda); the region's Chrome
    trace file (`trace_<pid>_<ns>.json`) goes into `logdir` when it
    ends:

        with device_trace("/tmp/prof"):
            deflate_device_static(data)
    """
    cuda = torch.device(device or "cuda").type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
