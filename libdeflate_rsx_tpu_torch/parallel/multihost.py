"""Multi-process batch dispatch over torch.distributed.

Port of `libdeflate_rsx_tpu/parallel/multihost.py`. Where the JAX
package speaks of hosts (processes with their local chips), the port
speaks of ranks, one card each:

- `initialize()`: `init_process_group`, NCCL when a card is present,
  else gloo, with the rendezvous from the arguments or the `torchrun`
  environment and an explicit timeout; the group is left at exit;
- `file_rendezvous()`: a `file://` rendezvous in a directory that the
  ranks of one machine share, so no TCP port is chosen before it is
  bound;
- `process_local_batch()`: the round-robin split of a global batch that
  every rank computes alike, with no traffic;
- `compress_local_shard()`: this rank's share on its own card, with no
  collective (the streams are independent);
- `global_sizes()`: an all-gather of the per-rank compressed totals;
- `compress_global()`: one container across ranks, each compressing its
  block-aligned slice, the payloads and checksum registers all-gathered.

NCCL takes one card per rank; ranks that share a card use gloo (their
collectives carry CPU tensors, their encoders still run on the card).
`initialize()` counts the ranks on each card into `budget.SHARERS`, so
that ranks sharing a card split its free memory between their passes.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .. import budget
from ..models.greedy_dynamic import split_many
from .shard import _Comm, encode_rows, stream_mesh

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (a no-op when already joined).

    init_method: a rendezvous URL such as "tcp://localhost:29500"
    (default "env://": MASTER_ADDR and MASTER_PORT, WORLD_SIZE and RANK
    from `torchrun`); backend: "nccl" when a CUDA card is present, else
    "gloo". Under NCCL each rank takes card LOCAL_RANK (default: its
    rank modulo the card count). `timeout` bounds the rendezvous and
    every collective. The group is destroyed at interpreter exit: a
    gloo rank that exits with its group alive can abort in the
    teardown of the group's threads (SIGABRT, "terminate called without
    an active exception") after its work is done."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=timeout)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              dist.get_rank() % torch.cuda.device_count())
    atexit.register(_leave)
    budget.SHARERS = _ranks_on_my_card()


def _leave() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _ranks_on_my_card() -> int:
    """How many ranks of the world (this one included) run on this
    rank's card, the current CUDA device: 1 without a card. Collective:
    an all-gather of every rank's host name and card UUID."""
    key = None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        key = (socket.gethostname(), str(props.uuid))
    keys = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    return 1 if key is None else keys.count(key)


def file_rendezvous(directory: str) -> str:
    """init_method of a rendezvous through a new file in `directory`,
    for ranks on one machine: unlike a TCP port picked before rank 0
    binds it, the file cannot be taken by another process meanwhile.
    Each process group needs its own file."""
    path = os.path.join(os.path.abspath(directory), "rendezvous")
    if os.path.exists(path):
        raise FileExistsError(f"{path}: a rendezvous file is used once")
    return "file://" + path


def global_stream_mesh():
    """The world group: every rank of every process."""
    return stream_mesh()


def process_local_batch(inputs: list) -> list:
    """This rank's share of a global batch: round-robin by rank."""
    rank, n = dist.get_rank(), dist.get_world_size()
    return [b for i, b in enumerate(inputs) if i % n == rank]


def _compress_local(datas: list[bytes], block_size: int, tier: str,
                    final: bool, device) -> list[bytes]:
    """Raw-DEFLATE outputs of independent buffers on this rank's card
    alone."""
    split = split_many(datas, block_size, False, final)
    parts = encode_rows(split, 0, len(split[1]), tier, block_size,
                        device)[0]
    return [b"".join(parts[start:start + num]) for start, num in split[0]]


def compress_local_shard(inputs: list, block_size: int = 65536,
                         level_tier: str = "static",
                         device=None) -> list[bytes]:
    """Compress this rank's round-robin share of a global batch on its
    own card (default: cuda), with no collective: the streams are
    independent, so only `global_sizes` needs the other ranks."""
    local = [bytes(x) for x in process_local_batch(inputs)]
    if not local:
        return []
    return _compress_local(local, block_size, level_tier, True,
                           torch.device(device or "cuda"))


def global_sizes(local_total: int, device=None) -> np.ndarray:
    """All-gather of the per-rank compressed totals, by rank: their
    exclusive scan gives every rank's offset in an ordered global
    concatenation. device: this rank's card under NCCL."""
    comm = _Comm(dist.group.WORLD, torch.device(device or "cuda"))
    return comm.gather_ints([int(local_total)])[:, 0]


def _host_slices(total_len: int, block_size: int) -> list[tuple[int, int]]:
    """Contiguous per-rank byte ranges, aligned to block_size so blocks
    never straddle ranks. Every rank computes the same."""
    n = dist.get_world_size()
    nblocks = max(1, -(-total_len // block_size))
    per = -(-nblocks // n)
    out = []
    for p in range(n):
        lo = min(p * per * block_size, total_len)
        hi = min((p + 1) * per * block_size, total_len)
        out.append((lo, hi))
    return out


def compress_global(data: bytes, format: str = "gzip",
                    block_size: int = 65536, device=None) -> bytes:
    """One byte-exact container across ranks.

    Each rank compresses its block-aligned slice of `data` on its card
    (non-final SYNC-joined blocks, except at the global tail); the
    payloads, their sizes and the slices' checksum registers are
    all-gathered, and every rank assembles the identical gzip, zlib or
    deflate stream, combining the registers with the crc32/adler32
    algebra instead of hashing the payload again."""
    from .. import containers
    from ..engine import adler32 as adler32_h
    from ..engine import crc32 as crc32_h
    from ..ops.checksum_math import adler32_combine, crc32_combine

    device = torch.device(device or "cuda")
    data = bytes(data)
    pid, nproc = dist.get_rank(), dist.get_world_size()
    slices = _host_slices(len(data), block_size)
    lo, hi = slices[pid]
    my = data[lo:hi]
    is_last = pid == nproc - 1 or slices[pid + 1][0] >= len(data)
    payload = b""
    if my:
        payload = _compress_local([my], block_size, "static", is_last,
                                  device)[0]
    if pid == 0 and not data:
        # the whole input is empty: rank 0 emits the final empty block
        payload = _compress_local([b""], block_size, "static", True,
                                  device)[0]
    crc = crc32_h(my) if format == "gzip" else 0
    adl = adler32_h(my) if format == "zlib" else 1

    comm = _Comm(dist.group.WORLD, device)
    metas = comm.gather_ints([len(payload), crc, adl, len(my)])
    body = b"".join(comm.gather_bytes(payload, metas[:, 0]))
    if format == "deflate":
        return body
    if format == "zlib":
        adler = 1
        for p in range(nproc):
            adler = adler32_combine(adler, int(metas[p, 2]),
                                    int(metas[p, 3]))
        return (containers.zlib_header(1) + body
                + containers.zlib_footer(adler))
    gcrc = 0
    for p in range(nproc):
        gcrc = crc32_combine(gcrc, int(metas[p, 1]), int(metas[p, 3]))
    return (containers.gzip_header(1) + body
            + containers.gzip_footer(gcrc, len(data)))
