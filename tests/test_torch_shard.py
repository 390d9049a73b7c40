"""The port's sharded paths (libdeflate_rsx_tpu_torch/parallel/shard.py)
at 2 gloo ranks on the CPU, held to the JAX package's on its 8-device
CPU mesh. Tolerance: exact equality (bytes and the None pattern).

The two ranks run once per module, as child processes that import no
JAX; they write their results to files, and this process compares them
with the JAX ShardedCompressor / ShardedDecompressor on the cases of
tests/test_parallel_shard.py. The bytes do not depend on the rank count,
so 2 ranks must give the JAX mesh's bytes. The JAX decoder runs in
__graft_entry__._dryrun_decode's configuration (max_steps=2048, one
stream group), so no new pass-1 step bucket is compiled: its pass 1 is
compiled once and run for each resolve."""

import gzip
import json
import os
import sys
import zlib

import pytest

from tests._port_corpus import (cut_stored_streams, make_corpus,
                                mutated_streams)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
TIMEOUT = 240       # seconds for both ranks
RENDEZVOUS = 120    # seconds a rank waits for the others: a rank left
                    # alone fails with its own message within TIMEOUT
NBLOCKS = (1, 3, 8, 17)
FORMATS = ("deflate", "zlib", "gzip")
DEC_CAP = 1024      # out_cap of the mixed decode set
MID = 30000         # decoded bytes of a mixed-set stream past DEC_CAP
BIG = 70000         # ... and of one past the 64 KiB pass-1 output cap
UNPACK = {"deflate": lambda b: zlib.decompress(b, -15),
          "zlib": zlib.decompress, "gzip": gzip.decompress}


def static_cases():
    """name -> (data, block size): the round trips at nblocks 1, 3, 8, 17,
    the checksum-combine inputs, and random blocks on the second rank
    (stored fallback, which reads the raw block at its global index)."""
    cases = {f"nb{nb}": (make_corpus("pattern", nb * 1024 - 123, seed=nb),
                         1024) for nb in NBLOCKS}
    cases["text"] = (make_corpus("text", 10 * 1024 + 17), 1024)
    cases["pattern9"] = (make_corpus("pattern", 9 * 1024), 1024)
    cases["mixed"] = (make_corpus("pattern", 4 * 1024, seed=4)
                      + make_corpus("random", 3 * 1024 + 9, seed=7), 1024)
    return cases


def batch_inputs():
    return [make_corpus("pattern", n, seed=n)
            for n in (1, 100, 1024, 5000, 3 * 1024)]


def dynamic_data():
    return make_corpus("text", 200000)


def dynamic_batch():
    """Text items, an empty one, and random blocks (stored fallback) in
    the second rank's rows."""
    return ([make_corpus("text", 30000, seed=i) for i in range(5)] + [b""]
            + [make_corpus("random", 40000, seed=8)])


def decode_originals():
    """__graft_entry__._dryrun_decode's six inputs (900-1,200 bytes)."""
    import numpy as np
    rng = np.random.default_rng(2)
    datas = []
    for i in range(6):
        base = rng.integers(0, 200, 40 + i, dtype=np.uint8).tobytes()
        datas.append((base * 40)[: 900 + 60 * i])
    return datas


def decode_mixed_data():
    """The originals (half of them past DEC_CAP), then MID and BIG
    bytes of pattern data."""
    return decode_originals() + [make_corpus("pattern", n, seed=5)
                                 for n in (MID, BIG)]


def decode_mixed():
    """decode_mixed_data's streams, bit-flipped streams and a short
    garbage stream, within one 128-stream group."""
    streams = [zlib.compress(d, 6)[2:-4] for d in decode_mixed_data()]
    return streams + mutated_streams(40, seed=11) + [b"\xff" * 40]


_WORKER = r"""
import datetime, json, sys, zlib
import torch
torch.set_num_threads(2)
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from tests import test_torch_shard as t
from libdeflate_rsx_tpu_torch.parallel import (
    ShardedCompressor, ShardedDecompressor, multihost, stream_mesh)

multihost.initialize(init, t.RANKS, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=t.RENDEZVOUS))
hx = lambda b: None if b is None else b.hex()
res = {}
for name, (data, bs) in t.static_cases().items():
    sc = ShardedCompressor(stream_mesh(), block_size=bs, device="cpu")
    for fmt in t.FORMATS:
        res[f"static/{name}/{fmt}"] = hx(sc.compress(data, fmt))
    res[f"static/{name}/nonfinal"] = hx(sc.compress(data, final=False))
sc = ShardedCompressor(stream_mesh([1, 0]), block_size=1024, device="cpu")
res["batch"] = [hx(o) for o in sc.compress_batch(t.batch_inputs())]
res["empty"] = sc.compress_batch([])
dyn = ShardedCompressor(block_size=16384, tier="dynamic", device="cpu")
for fmt in t.FORMATS:
    res[f"dynamic/{fmt}"] = hx(dyn.compress(t.dynamic_data(), fmt))
res["dynamic/nonfinal"] = hx(dyn.compress(t.dynamic_data(), final=False))
res["dynamic/batch"] = [hx(o) for o in dyn.compress_batch(t.dynamic_batch())]
for resolve in ("host", "device"):
    streams = [zlib.compress(d, 6)[2:-4] for d in t.decode_originals()]
    dec = ShardedDecompressor(resolve=resolve, device="cpu")
    res[f"decode/{resolve}"] = [hx(o) for o in dec.decompress_batch(streams)]
    dec = ShardedDecompressor(resolve=resolve, out_cap=t.DEC_CAP,
                              device="cpu")
    res[f"mixed/{resolve}"] = [hx(o)
                               for o in dec.decompress_batch(t.decode_mixed())]
    res[f"cut/{resolve}"] = [hx(o) for o in dec.decompress_batch(
        [z for z, _ in t.cut_stored_streams()])]
res["jax_loaded"] = sorted(m for m in sys.modules if m.startswith("jax")
                           or m.split(".")[0] == "libdeflate_rsx_tpu")
json.dump(res, open(out, "w"))
"""


def run_ranks(worker: str, tmp, n: int = RANKS) -> list:
    """Run `worker` as n gloo ranks (argv: rank, rendezvous URL, result
    file, repo root) through `parallel/entry.run_ranks`: when a rank
    fails or the ranks outlast TIMEOUT, every rank is killed and the
    error shows each rank's exit code and the tail of its stderr.
    Returns the ranks' results."""
    from libdeflate_rsx_tpu_torch.parallel.entry import run_ranks as run
    outs = [str(tmp / f"rank{r}.json") for r in range(n)]
    run(lambda r, init: [sys.executable, "-c", worker, str(r), init,
                         outs[r], ROOT], n, TIMEOUT)
    return [json.load(open(o)) for o in outs]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(_WORKER, tmp_path_factory.mktemp("shard"))


@pytest.fixture(scope="module")
def mesh():
    from libdeflate_rsx_tpu.parallel import stream_mesh
    return stream_mesh()


def unhex(x):
    return None if x is None else bytes.fromhex(x)


def test_ranks_agree_and_load_no_jax(port):
    assert port[0] == port[1]
    assert port[0]["jax_loaded"] == []


@pytest.mark.parametrize("name", list(static_cases()))
@pytest.mark.parametrize("fmt", FORMATS + ("nonfinal",))
def test_static_tier_equals_jax(port, mesh, name, fmt):
    from libdeflate_rsx_tpu.parallel import ShardedCompressor
    data, bs = static_cases()[name]
    ref = ShardedCompressor(mesh=mesh, block_size=bs)
    want = (ref.compress(data, final=False) if fmt == "nonfinal"
            else ref.compress(data, fmt))
    got = unhex(port[0][f"static/{name}/{fmt}"])
    assert got == want
    if fmt in UNPACK:
        assert UNPACK[fmt](got) == data


def test_batch_many_inputs_equals_jax(port, mesh):
    from libdeflate_rsx_tpu.parallel import ShardedCompressor
    inputs = batch_inputs()
    want = ShardedCompressor(mesh=mesh, block_size=1024) \
        .compress_batch(inputs)
    got = [unhex(o) for o in port[0]["batch"]]
    assert got == want
    for data, out in zip(inputs, got):
        assert zlib.decompress(out, -15) == data


def test_empty_batch(port):
    assert port[0]["empty"] == []


@pytest.mark.parametrize("fmt", FORMATS + ("nonfinal",))
def test_dynamic_tier_equals_jax(port, mesh, fmt):
    from libdeflate_rsx_tpu.parallel import ShardedCompressor
    data = dynamic_data()
    ref = ShardedCompressor(mesh=mesh, block_size=16384, tier="dynamic")
    want = (ref.compress(data, final=False) if fmt == "nonfinal"
            else ref.compress(data, fmt))
    got = unhex(port[0][f"dynamic/{fmt}"])
    assert got == want
    if fmt in UNPACK:
        assert UNPACK[fmt](got) == data


def test_dynamic_batch_equals_jax(port, mesh):
    from libdeflate_rsx_tpu.parallel import ShardedCompressor
    items = dynamic_batch()
    want = ShardedCompressor(mesh=mesh, block_size=16384, tier="dynamic") \
        .compress_batch(items)
    got = [unhex(o) for o in port[0]["dynamic/batch"]]
    assert got == want
    for d, o in zip(items, got):
        assert zlib.decompress(o, -15) == d


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_decoder_gives_the_originals(port, resolve):
    assert [unhex(o) for o in port[0][f"decode/{resolve}"]] == \
        decode_originals()


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_decoder_gives_none_for_cut_stored_streams(port, resolve):
    """Raw-DEFLATE streams whose final stored block is cut by one byte
    give None on every rank (the JAX package's pass 1 accepts them with
    the last byte read as 0: tests/test_torch_inflate_tokens.py)."""
    for rank in port:
        assert rank[f"cut/{resolve}"] == [None] * len(cut_stored_streams())


@pytest.fixture(scope="module")
def jax_mixed(mesh):
    """The JAX decoder's results on the mixed set, by resolve: its
    sharded pass 1 stops every stream at 64 KiB of output, and out_cap
    bounds only the device resolve."""
    from libdeflate_rsx_tpu.parallel import ShardedDecompressor
    return {resolve: ShardedDecompressor(
        mesh, max_steps=2048, resolve=resolve,
        out_cap=DEC_CAP).decompress_batch(decode_mixed())
        for resolve in ("host", "device")}


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_decoder_none_pattern_equals_jax(port, jax_mixed, resolve):
    got = [unhex(o) for o in port[0][f"mixed/{resolve}"]]
    want = jax_mixed[resolve]
    assert [g is None for g in got] == [w is None for w in want]
    assert got == want
    datas = decode_mixed_data()
    n = len(datas)
    assert got[n - 1] is None                        # past 64 KiB
    if resolve == "host":                            # no DEC_CAP
        assert got[:n - 1] == datas[:n - 1]
    else:
        assert got[n - 2] is None                    # past DEC_CAP
        assert any(g is None for g in got[:n - 2])
    assert any(g is not None for g in got[n:])       # bit-flipped, DONE
