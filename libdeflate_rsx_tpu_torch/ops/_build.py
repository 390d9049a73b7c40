"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C entry point. It is compiled with nvcc
for sm_90a into a shared library under `build/kernels/` at the root of
the checkout (listed in .gitignore), named by a hash of its source, the
`csrc/*.cuh` headers it includes and the flags, so that an edited source
or header is rebuilt, and loaded with ctypes. The
build happens at first use, never at import: the first `load` compiles
every missing kernel of `csrc/`, one nvcc each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each kernel took to compile in this process (absent: cached)
BUILD_SECONDS: dict[str, float] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME / CUDA_PATH, else
    where PyTorch's extension builder finds the toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    if not any(homes):
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    for home in homes:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(name: str) -> list[str]:
    """`csrc/<name>.cu` and every header of `csrc/` it includes, directly
    or through another header, in the order they are first met."""
    found = [os.path.join(CSRC, name + ".cu")]
    for path in found:
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(CSRC, inc.decode())
                if os.path.exists(dep) and dep not in found:
                    found.append(dep)
    return found


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source, the headers it
    includes and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build_missing() -> None:
    """Compile each missing library of `csrc/`: one nvcc per source, all
    started together. The compiler's resource report (-Xptxas -v) goes
    to `<library>.log`. Call with _lock held."""
    jobs = []
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        jobs.append((name, so, tmp, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, so, tmp, t0, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{err}")
            continue
        BUILD_SECONDS[name] = time.perf_counter() - t0
        with open(so + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Load the library of `csrc/<name>.cu`, compiling the missing ones
    first."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build_missing()
        lib = ctypes.CDLL(library_path(name))
        _libs[name] = lib
        return lib
