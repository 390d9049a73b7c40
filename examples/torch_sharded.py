"""Multi-rank data-parallel compression and decode with the PyTorch
port, over a torch.distributed process group (the JAX package's
examples/sharded.py runs the same calls over a device mesh).

  python examples/torch_sharded.py [--ranks N] [--device cuda|cpu]

starts N ranks (default 2) as child processes that meet at a file
rendezvous and talk over gloo; with one card they share it, each
running its encoders and decoders there. --device cpu runs every
device step's plain PyTorch version on the CPU. Rank 0 prints; a failed
or late rank makes the example exit non-zero with each rank's exit
code. (Under NCCL, one rank per card, start the ranks with `torchrun`
and call multihost.initialize() with no arguments.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import argparse
import datetime
import gzip
import zlib

RANK_TIMEOUT = 300      # seconds for the whole run of the ranks
RENDEZVOUS = 120        # seconds a rank waits for the others

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--ranks", type=int, default=2)
parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
parser.add_argument("--init", help=argparse.SUPPRESS)
args = parser.parse_args()

if args.rank is None:
    from libdeflate_rsx_tpu_torch.parallel.entry import run_ranks

    sys.stdout.flush()
    run_ranks(lambda rank, init: [
        sys.executable, os.path.abspath(__file__), "--ranks",
        str(args.ranks), "--device", args.device, "--rank", str(rank),
        "--init", init], args.ranks, RANK_TIMEOUT, stdout0=sys.stdout)
    sys.exit(0)

import torch.distributed as dist

from libdeflate_rsx_tpu_torch.parallel import (AXIS, ShardedCompressor,
                                               ShardedDecompressor,
                                               multihost, stream_mesh)

multihost.initialize(args.init, args.ranks, args.rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=RENDEZVOUS))
mesh = stream_mesh()
n = dist.get_world_size(mesh)
print(f"mesh: {n} ranks on axis '{AXIS}'")

data = b"a multi-chip pod slice compressing one big buffer " * 40000
sc = ShardedCompressor(mesh, block_size=65536, device=args.device)

# blocks shard across every rank; concat offsets come from an all-gather
# of the byte counts; CRC-32 is computed per block on the device and
# combined associatively on the host
framed = sc.compress(data, format="gzip")
assert gzip.decompress(framed) == data
print(f"gzip: {len(data)} -> {len(framed)} bytes across the ranks")

# many independent buffers ride one sharded call
outs = sc.compress_batch([data[:10000], data[:50000], data])
print("batch sizes:", [len(o) for o in outs])

# sharded DECODE: each rank takes its share of the streams through the
# two-pass decoder (pass 1 on its device), the bytes all-gathered
streams = [zlib.compress(bytes([65 + i]) * 5000 + data[:2000], 6)[2:-4]
           for i in range(6)]
dec = ShardedDecompressor(mesh, device=args.device)
outs = dec.decompress_batch(streams)
assert all(o is not None for o in outs)
print(f"sharded decode: {len(outs)} streams OK")

# resolve="device" keeps pass 2 (LZ copy resolution) on the device too:
# only decoded bytes leave it
dec_dev = ShardedDecompressor(mesh, resolve="device", out_cap=16384,
                              device=args.device)
outs2 = dec_dev.decompress_batch(streams)
assert outs2 == outs
print(f"sharded decode (device resolve): {len(outs2)} streams OK")

print(f"compressed {len(data)} -> {len(framed)} bytes "
      f"({len(data) / len(framed):.2f}x) across {n} ranks")
