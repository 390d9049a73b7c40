"""Multi-rank global container with the PyTorch port: every rank emits
the byte-identical gzip file for one logical buffer sharded across the
ranks (the JAX package's examples/multihost_global.py runs the same
call across hosts).

  python examples/torch_multihost_global.py [--ranks N] [--device cuda|cpu]

starts N ranks (default 2) as child processes that meet at a file
rendezvous and talk over gloo; with one card they share it. --device
cpu runs the device steps' plain PyTorch versions on the CPU. Every
rank checks its container with gzip and that the ranks' digests are
equal; rank 0 prints. A failed or late rank makes the example exit
non-zero with each rank's exit code.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run from anywhere

import argparse
import datetime
import gzip
import hashlib

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

from libdeflate_rsx_tpu_torch.parallel import multihost as mh

mh.initialize(args.init, args.ranks, args.rank, backend="gloo",
              timeout=datetime.timedelta(seconds=RENDEZVOUS))
data = b"one logical file, block-sharded across hosts and chips " * 30000
out = mh.compress_global(data, "gzip", block_size=65536, device=args.device)
assert gzip.decompress(out) == data
digests = [None] * dist.get_world_size()
dist.all_gather_object(digests, hashlib.sha256(out).hexdigest())
assert len(set(digests)) == 1, digests
print(f"global gzip container: {len(data)} -> {len(out)} bytes; "
      f"per-rank slices are SYNC-joined non-final shards, checksums "
      f"combine associatively over the process group")
print(f"{len(digests)} ranks emitted the same container "
      f"(sha256 {digests[0][:16]}…)")
