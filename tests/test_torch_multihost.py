"""The port's multi-process paths (libdeflate_rsx_tpu_torch/parallel/
multihost.py and entry.py) at 2 gloo ranks on the CPU, held to the JAX
package. Tolerance: exact equality (bytes and sizes).

The two ranks run once per module as child processes that import no
JAX (tests/test_torch_shard.run_ranks). `compress_global` must equal the
bytes the JAX package gives for the same two block-aligned slices,
built here from the JAX ShardedCompressor (final=False, then
final=True) and the headers and footers of
libdeflate_rsx_tpu/parallel/multihost.py."""

import gzip
import zlib

import numpy as np
import pytest
import torch

from tests.test_torch_shard import run_ranks

BLOCK = 65536
FORMATS = ("gzip", "zlib", "deflate")


def global_batch():
    """The global batch, the same on every rank."""
    return [bytes([66 + i]) * 20000 + bytes(range(256)) * (40 + i)
            for i in range(5)]


def global_data():
    return bytes([7 * i % 251 for i in range(300_000)]) + b"tail" * 999


_WORKER = r"""
import datetime, json, sys
import torch
torch.set_num_threads(2)
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from tests import test_torch_multihost as t
from tests.test_torch_shard import RENDEZVOUS
from libdeflate_rsx_tpu_torch import budget
from libdeflate_rsx_tpu_torch.parallel import multihost as mh

mh.initialize(init, 2, rank, backend="gloo",
              timeout=datetime.timedelta(seconds=RENDEZVOUS))
mh.initialize()                       # joined already: a no-op
batch = t.global_batch()
outs = mh.compress_local_shard(batch, device="cpu")
local_total = sum(len(o) for o in outs)
res = {"rank": rank,
       "local": [o.hex() for o in outs],
       "n_local": len(mh.process_local_batch(batch)),
       "local_total": local_total,
       "global_sizes": [int(s) for s in mh.global_sizes(local_total)],
       "slices": mh._host_slices(len(t.global_data()), t.BLOCK),
       "sharers": budget.SHARERS}
for fmt in t.FORMATS:
    res[fmt] = mh.compress_global(t.global_data(), fmt, t.BLOCK,
                                  device="cpu").hex()
res["empty"] = mh.compress_global(b"", "gzip", t.BLOCK, device="cpu").hex()
res["jax_loaded"] = sorted(m for m in sys.modules if m.startswith("jax")
                           or m.split(".")[0] == "libdeflate_rsx_tpu")
json.dump(res, open(out, "w"))
"""


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(_WORKER, tmp_path_factory.mktemp("multihost"))


@pytest.fixture(scope="module")
def jax_sc():
    from libdeflate_rsx_tpu.parallel import ShardedCompressor, stream_mesh
    return ShardedCompressor(stream_mesh(), block_size=BLOCK)


def test_ranks_split_gather_and_load_no_jax(port):
    r0, r1 = port
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["n_local"] == 3 and r1["n_local"] == 2      # round robin
    assert r0["global_sizes"] == r1["global_sizes"] == \
        [r0["local_total"], r1["local_total"]]
    assert r0["jax_loaded"] == r1["jax_loaded"] == []
    assert r0["sharers"] == r1["sharers"] == 1            # no card here


def test_local_shard_equals_jax(port, jax_sc):
    batch = global_batch()
    for r in port:
        mine = batch[r["rank"]::2]
        got = [bytes.fromhex(o) for o in r["local"]]
        assert got == jax_sc.compress_batch(mine)
        for d, o in zip(mine, got):
            assert zlib.decompress(o, -15) == d


def jax_global(sc, data: bytes, fmt: str, slices) -> bytes:
    """The JAX package's compress_global bytes for these slices, one
    ShardedCompressor call per slice (libdeflate_rsx_tpu/parallel/
    multihost.py:156-194, without its collectives)."""
    from libdeflate_rsx_tpu import containers
    from libdeflate_rsx_tpu.engine import adler32, crc32
    from libdeflate_rsx_tpu.ops.checksum_math import (adler32_combine,
                                                      crc32_combine)
    body, crc, adler = b"", 0, 1
    for p, (lo, hi) in enumerate(slices):
        my = data[lo:hi]
        last = p == len(slices) - 1 or slices[p + 1][0] >= len(data)
        if my:
            body += sc.compress(my, "deflate", final=last)
        elif p == 0 and not data:
            body += sc.compress(b"", "deflate", final=True)
        crc = crc32_combine(crc, crc32(my), len(my))
        adler = adler32_combine(adler, adler32(my), len(my))
    if fmt == "deflate":
        return body
    if fmt == "zlib":
        return (containers.zlib_header(1) + body
                + containers.zlib_footer(adler))
    return (containers.gzip_header(1) + body
            + containers.gzip_footer(crc, len(data)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_compress_global_equals_jax(port, jax_sc, fmt):
    data = global_data()
    r0, r1 = port
    assert r0[fmt] == r1[fmt]
    slices = [tuple(s) for s in r0["slices"]]
    assert slices == [(0, 3 * BLOCK), (3 * BLOCK, len(data))]
    got = bytes.fromhex(r0[fmt])
    assert got == jax_global(jax_sc, data, fmt, slices)
    plain = {"gzip": gzip.decompress, "zlib": zlib.decompress,
             "deflate": lambda b: zlib.decompress(b, -15)}[fmt]
    assert plain(got) == data


def test_compress_global_of_nothing_equals_jax(port, jax_sc):
    assert port[0]["empty"] == port[1]["empty"]
    got = bytes.fromhex(port[0]["empty"])
    assert got == jax_global(jax_sc, b"", "gzip", [(0, 0), (0, 0)])
    assert gzip.decompress(got) == b""


def test_entry_equals_jax():
    import jax

    from __graft_entry__ import entry as jax_entry
    from libdeflate_rsx_tpu_torch.parallel.entry import entry
    fn, args = entry(device="cpu")
    jfn, jargs = jax_entry()
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = jax.jit(jfn)(*jargs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))
    assert int(got[4].sum()) > 0
    assert isinstance(args[0], torch.Tensor)


def test_dryrun_multichip_two_ranks():
    from libdeflate_rsx_tpu_torch.parallel.entry import dryrun_multichip
    dryrun_multichip(2, timeout=240)
