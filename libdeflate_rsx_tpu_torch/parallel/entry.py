"""The port's entry points: a single-card forward step and a multi-rank
dry run.

`entry()` returns the flagship forward step, the level-1-tier
static-Huffman block encoder (`ops/encode_v2.encode_rows_static`) over
a batch of blocks, with example arguments on the card (or the CPU).

`dryrun_multichip(n)` starts n gloo ranks on the CPU, each a child
process with a timeout (`run_ranks`, which the port's distributed
examples use too), that run the sharded gzip round trip of the
static tier, the dynamic tier and the sharded two-pass decode on tiny
shapes. The ranks meet at a file rendezvous in a temporary directory.
Run one rank by hand with
`python -m libdeflate_rsx_tpu_torch.parallel.entry RANK N INIT_METHOD
SECONDS` (SECONDS: how long it waits for the others).
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def entry(device=None):
    """(fn, example_args): the static-tier block encoder on 8 blocks of
    16 KiB, on `device` (default: cuda)."""
    from ..ops.encode_v2 import BLOCK_PAD, encode_rows_static

    device = torch.device(device or "cuda")
    block_size = 16384
    batch = 8
    fn = functools.partial(encode_rows_static, block_size=block_size)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, 100, dtype=np.uint8)
    row = np.tile(base, block_size // len(base) + 1)[:block_size]
    blocks = np.zeros((batch, block_size + BLOCK_PAD), np.uint8)
    blocks[:, :block_size] = row
    valids = np.full(batch, block_size, np.int32)
    finals = np.zeros(batch, bool)
    finals[-1] = True
    example_args = tuple(torch.from_numpy(a).to(device)
                         for a in (blocks, valids, finals))
    return fn, example_args


def run_ranks(command, n: int, timeout: float, stdout0=None) -> None:
    """Run n ranks, each the child process `command(rank, init)` (an argv
    list) from the repo root, that meet at `init`, a file rendezvous in a
    new temporary directory. Rank 0's stdout goes to `stdout0` (default:
    discarded), the others' is discarded; each rank's stderr goes to a
    temporary file. Raises RuntimeError when a rank fails or the ranks
    outlast `timeout` seconds: every rank is killed then, and the error
    holds each rank's exit code and the tail of its stderr."""
    from .multihost import file_rendezvous

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    deadline = time.monotonic() + timeout
    with contextlib.ExitStack() as stack:
        init = file_rendezvous(stack.enter_context(
            tempfile.TemporaryDirectory()))
        logs = [stack.enter_context(tempfile.TemporaryFile("w+"))
                for _ in range(n)]
        procs = [subprocess.Popen(
            command(rank, init), cwd=ROOT, env=env,
            stdout=stdout0 if rank == 0 and stdout0 is not None
            else subprocess.DEVNULL, stderr=log)
            for rank, log in enumerate(logs)]
        try:
            while any(p.poll() is None for p in procs) \
                    and time.monotonic() < deadline \
                    and all(p.poll() in (None, 0) for p in procs):
                time.sleep(0.1)
        finally:
            codes = [p.poll() for p in procs]
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        if codes != [0] * n:
            why = ("a rank failed" if any(c not in (None, 0) for c in codes)
                   else f"the ranks outlasted {timeout} s")
            tails = []
            for rank, log in enumerate(logs):
                log.seek(0)
                tails.append(f"rank {rank} (exit {codes[rank]}):\n"
                             f"{log.read()[-3000:]}")
            raise RuntimeError(f"{why}; every rank killed:\n"
                               + "\n".join(tails))


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> None:
    """Run the sharded paths on n_devices gloo ranks on the CPU, each a
    child process; the ranks wait half of `timeout` for each other. Raises
    when a rank fails or the ranks outlast `timeout` seconds: every
    child is killed then, and the error holds each rank's stderr tail."""
    run_ranks(lambda rank, init: [
        sys.executable, "-m", "libdeflate_rsx_tpu_torch.parallel.entry",
        str(rank), str(n_devices), init, str(timeout / 2)],
        n_devices, timeout)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what} failed")


def _dryrun_rank(rank: int, n_devices: int, init: str,
                 seconds: float) -> None:
    """One rank of the dry run: the gzip round trip of the static tier,
    the dynamic tier and the sharded decode, as the JAX package's
    dry run does on its mesh. The rank waits `seconds` for the others."""
    import gzip
    import zlib

    import torch.distributed as dist

    from . import ShardedCompressor, ShardedDecompressor, multihost

    multihost.initialize(init, n_devices, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=seconds))
    block_size = 1024
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, 37, dtype=np.uint8)
    data = np.tile(base, (2 * n_devices * block_size) // len(base))[
        : 2 * n_devices * block_size - 100].tobytes()
    comp = ShardedCompressor(block_size=block_size, device="cpu")
    framed = comp.compress(data, format="gzip")
    _check(gzip.decompress(framed) == data, "the sharded gzip round trip")
    dyn = ShardedCompressor(block_size=block_size, tier="dynamic",
                            device="cpu")
    _check(zlib.decompress(dyn.compress(data), -15) == data,
           "the sharded dynamic-tier round trip")

    rng = np.random.default_rng(2)
    datas = []
    for i in range(6):
        base = rng.integers(0, 200, 40 + i, dtype=np.uint8).tobytes()
        datas.append((base * 40)[: 900 + 60 * i])
    streams = [zlib.compress(d, 6)[2:-4] for d in datas]
    got = ShardedDecompressor(device="cpu").decompress_batch(streams)
    _check(got == datas, "the sharded decode round trip")
    dist.destroy_process_group()


if __name__ == "__main__":
    _dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                 float(sys.argv[4]))
