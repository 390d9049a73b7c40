"""Data parallelism over a torch.distributed process group.

Port of `libdeflate_rsx_tpu/parallel/shard.py`. The JAX package shards a
batch of independent blocks over the 1-D device mesh axis "streams";
here the axis is a process group with one rank per card: NCCL with CUDA
tensors in the collectives, or gloo with CPU tensors (on the CPU, or for
several ranks that share one card). Every rank is given the same inputs
and returns the same outputs:

- each rank encodes and assembles its contiguous share of the block
  rows on its device, in as few passes as the memory budget allows
  (`budget.py`); a row's stored fallback reads the row's own raw bytes,
  which are its block's bytes at its place in the whole input;
- the per-row byte counts, taken after the stored fallback, are
  all-gathered; the exclusive scan of the per-rank totals gives the
  offset at which each rank's payload lands, and the payloads are
  all-gathered, padded to the largest;
- on zlib/gzip the static tier computes each block's CRC-32 or Adler-32
  register on the device (`ops/checksums.py`) and combines them on the
  host (`ops/checksum_math.py`); the dynamic tier checksums on the host.

Blocks are independent, so the bytes do not depend on the rank count:
at any world size they equal the JAX package's on its mesh.
`ShardedDecompressor` gives each rank its share of the streams for the
two-pass decoder (the pass-1 kernel, then resolution on the host or the
card) and all-gathers the decoded bytes.

`torch.distributed` must be initialized first (`multihost.initialize`);
nothing here runs as a single process in its place.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .. import budget
from ..models.greedy_dynamic import _encode_blocks, split_many
from ..models.greedy_static import split_blocks, static_rows
from ..ops.checksum_math import adler32_combine, crc32_combine
from ..ops.checksums import adler32_blocks, crc32_blocks

AXIS = "streams"


def _require_init() -> None:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize() first")


def stream_mesh(ranks=None):
    """The process group over `ranks` (default: the world group), the
    port's "streams" axis. A new group is made by `dist.new_group`,
    which is collective: every rank of the world calls this with the
    same ranks, in the same order."""
    _require_init()
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(sorted(ranks))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _share(n: int, size: int, rank: int) -> tuple[int, int]:
    """Rank `rank`'s contiguous share [lo, hi) of n units over `size`
    ranks: the split of n units padded to a multiple of size."""
    per = -(-n // size)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def shard_blocks(data: bytes, block_size: int, n_devices: int):
    """Split one buffer into shardable padded block rows; the row count
    is padded to a multiple of n_devices (padding rows are empty final
    blocks whose outputs are dropped at assembly)."""
    arr, valid, finals, num = split_blocks(data, block_size)
    rows = _round_up(num, n_devices)
    if rows > num:
        pad = rows - num
        arr = np.concatenate(
            [arr, np.zeros((pad, arr.shape[1]), np.uint8)])
        valid = np.concatenate([valid, np.zeros(pad, np.int32)])
        finals = np.concatenate([finals, np.ones(pad, bool)])
    return arr, valid, finals, num


class _Comm:
    """The collectives of one group: all-gathers of int64 rows and of
    byte payloads, on the rank's card under NCCL and on the CPU under
    gloo, timed into `seconds`."""

    def __init__(self, group, device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = device if dist.get_backend(group) == "nccl" \
            else torch.device("cpu")
        self.seconds = 0.0

    def gather_ints(self, values) -> np.ndarray:
        """(size, len(values)) int64: every rank's row, by rank."""
        t0 = time.perf_counter()
        mine = torch.tensor(values, dtype=torch.int64, device=self.device)
        rows = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(rows, mine, group=self.group)
        out = torch.stack(rows).cpu().numpy()
        self.seconds += time.perf_counter() - t0
        return out

    def gather_bytes(self, payload: bytes, sizes) -> list[bytes]:
        """Every rank's payload, by rank; sizes[r] is rank r's length."""
        t0 = time.perf_counter()
        pad = max(1, int(max(sizes)))
        mine = torch.zeros(pad, dtype=torch.uint8)
        if payload:
            mine[:len(payload)] = torch.frombuffer(bytearray(payload),
                                                   dtype=torch.uint8)
        mine = mine.to(self.device)
        bufs = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(bufs, mine, group=self.group)
        out = [b[:int(n)].cpu().numpy().tobytes()
               for b, n in zip(bufs, sizes)]
        self.seconds += time.perf_counter() - t0
        return out


def encode_rows(split, lo: int, hi: int, tier: str, block_size: int,
                device, checksums: bool = False):
    """Rows lo..hi-1 of a batch (`greedy_dynamic.split_many`) encoded and
    assembled on `device` in budget passes, the stored fallback applied
    to each row's own raw bytes there: (parts, one bytes per
    row; crcs, adlers: with checksums, the CRC-32 and Adler-32 registers
    of each row's raw bytes, int64 numpy, else None)."""
    _, arr, valid, _, finals = split
    crcs, adlers = [], []

    def encode(a, b):
        if tier == "dynamic":
            return _encode_blocks(arr[a:b], valid[a:b], finals[a:b],
                                  block_size, device)
        if checksums:
            # the strided view (rows of block_size + BLOCK_PAD) is not
            # dense, so the copy to the card is contiguous
            body = torch.from_numpy(arr[a:b, :block_size]).to(device)
            n = torch.from_numpy(valid[a:b]).to(device)
            crcs.append(crc32_blocks(body, n).cpu().numpy())
            adlers.append(adler32_blocks(body, n).cpu().numpy())
        return static_rows(arr[a:b], valid[a:b], finals[a:b], block_size,
                           device)

    spans = [(a + lo, b + lo) for a, b in budget.passes(
        tier, [arr.shape[1]] * (hi - lo), device)]
    parts = [part for a, b in spans for part in encode(a, b)]
    if not checksums:
        return parts, None, None
    cat = (lambda x: np.concatenate(x).astype(np.int64) if x
           else np.zeros(0, np.int64))
    return parts, cat(crcs), cat(adlers)


def _combine(crcs, adlers, lens) -> tuple[int, int]:
    """One CRC-32 and one Adler-32 of consecutive pieces' registers."""
    crc, adler = 0, 1
    for c, a, n in zip(crcs, adlers, lens):
        crc = crc32_combine(crc, int(c), int(n))
        adler = adler32_combine(adler, int(a), int(n))
    return crc, adler


class ShardedCompressor:
    """Data-parallel whole-buffer / batch DEFLATE encoder over a process
    group: static-Huffman blocks (the level-1 tier) or dynamic-Huffman
    blocks (the level 4-5 tier), sharded by rows over the ranks, with
    device checksums combined on the host for zlib/gzip framing.

    group: the process group (default: the world group); device: this
    rank's card (default: cuda). `collective_seconds` sums the time of
    the last call's collectives."""

    def __init__(self, group=None, block_size: int = 65536,
                 tier: str = "static", device=None) -> None:
        if tier not in ("static", "dynamic"):
            raise ValueError(f"unknown tier {tier!r}")
        self.group = group if group is not None else stream_mesh()
        self.block_size = block_size
        self.tier = tier
        self.device = torch.device(device if device is not None else "cuda")
        self.n_devices = dist.get_world_size(self.group)
        self.collective_seconds = 0.0

    def _run(self, datas: list[bytes], final: bool, checksums: bool):
        """(metas, every row's part, on every rank; with checksums the
        CRC-32 and Adler-32 of the whole input from the device
        registers, else None)."""
        comm = _Comm(self.group, self.device)
        split = split_many(datas, self.block_size, False, final)
        metas, valid = split[0], split[2]
        num = len(valid)
        lo, hi = _share(num, comm.size, comm.rank)
        parts, crcs, adlers = encode_rows(
            split, lo, hi, self.tier, self.block_size, self.device,
            checksums)
        per = -(-num // comm.size)
        sizes = [len(p) for p in parts]
        crc, adler = (_combine(crcs, adlers, valid[lo:hi]) if checksums
                      else (0, 1))
        table = comm.gather_ints([sum(sizes), crc, adler,
                                  int(valid[lo:hi].sum())]
                                 + sizes + [0] * (per - len(sizes)))
        totals = table[:, 0]
        offsets = np.concatenate([[0], np.cumsum(totals)[:-1]])
        body = b"".join(comm.gather_bytes(b"".join(parts), totals))
        rows = []
        for r in range(comm.size):
            r_lo, r_hi = _share(num, comm.size, r)
            ends = offsets[r] + np.cumsum(table[r, 4:4 + r_hi - r_lo])
            starts = np.concatenate([[offsets[r]], ends[:-1]])
            rows += [body[s:e] for s, e in zip(starts, ends)]
        self.collective_seconds = comm.seconds
        sums = _combine(*table[:, 1:4].T) if checksums else None
        return metas, rows, sums

    def compress(self, data: bytes, format: str = "deflate",
                 final: bool = True) -> bytes:
        """Compress one buffer, blocks sharded across every rank.

        final=False emits the last block as a non-final SYNC-joined block
        (byte-aligned), so streams of successive slices concatenate into
        one valid DEFLATE stream (only raw deflate supports it)."""
        if format not in ("deflate", "zlib", "gzip"):
            raise ValueError(f"unknown format {format!r}")
        if not final and format != "deflate":
            raise ValueError("final=False requires format='deflate'")
        data = bytes(data)
        device_sums = self.tier == "static" and format != "deflate"
        _, rows, sums = self._run([data], final, device_sums)
        payload = b"".join(rows)
        if format == "deflate":
            return payload
        from .. import containers
        if self.tier == "dynamic":
            from ..engine import adler32 as adler32_h
            from ..engine import crc32 as crc32_h
            level, crc, adler = 6, crc32_h(data), adler32_h(data)
        else:
            level, (crc, adler) = 1, sums
        if format == "zlib":
            return (containers.zlib_header(level) + payload
                    + containers.zlib_footer(adler))
        return (containers.gzip_header(level) + payload
                + containers.gzip_footer(crc, len(data)))

    def compress_batch(self, inputs) -> list[bytes]:
        """Many independent buffers: their blocks are sharded together
        over the ranks; one raw-DEFLATE output per input, in order."""
        datas = [bytes(x) for x in inputs]
        if not datas:
            return []
        metas, rows, _ = self._run(datas, True, False)
        return [b"".join(rows[start:start + num])
                for start, num in metas]


class ShardedDecompressor:
    """Data-parallel batch DEFLATE decode over a process group.

    Each rank takes its contiguous share of the streams through the
    two-pass decoder: the pass-1 kernel (`ops/inflate_tokens.pass1`),
    then LZ resolution on the host pool (resolve="host") or on its card
    (resolve="device"), in budget passes. As in the JAX package, whose
    sharded pass 1 stops every stream at its 64 KiB output cap
    (OUT_CAP) whatever the resolve, a stream gives None when it is over
    the 64 KiB input cap, pass 1 does not finish it, or its output
    passes 64 KiB; with resolve="device" also when its output passes
    out_cap. There is no host fallback. The decoded bytes are
    all-gathered, so every rank returns the same list."""

    def __init__(self, group=None, resolve: str = "host",
                 out_cap: int = 65536, device=None) -> None:
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be host|device: {resolve!r}")
        self.group = group if group is not None else stream_mesh()
        self.resolve = resolve
        self.out_cap = out_cap
        self.device = torch.device(device if device is not None else "cuda")
        self.n_devices = dist.get_world_size(self.group)
        self.collective_seconds = 0.0

    def _decode(self, streams: list[bytes]) -> list:
        from ..ops import inflate_tokens as it

        if self.resolve == "host":
            return it.inflate_device_tokens(streams, it.OUT_CAP, it.IN_CAP,
                                            self.device)
        return it.inflate_device_fused(
            streams, min(self.out_cap, it.OUT_CAP), it.IN_CAP, self.device)

    def decompress_batch(self, streams) -> list:
        streams = [bytes(s) for s in streams]
        n = len(streams)
        if n == 0:
            return []
        comm = _Comm(self.group, self.device)
        lo, hi = _share(n, comm.size, comm.rank)
        mine = self._decode(streams[lo:hi])
        per = -(-n // comm.size)
        lens = [-1 if r is None else len(r) for r in mine]
        table = comm.gather_ints([sum(max(x, 0) for x in lens)]
                                 + lens + [-1] * (per - len(lens)))
        payloads = comm.gather_bytes(b"".join(r for r in mine if r),
                                     table[:, 0])
        out = []
        for r in range(comm.size):
            r_lo, r_hi = _share(n, comm.size, r)
            pos = 0
            for ln in table[r, 1:1 + r_hi - r_lo]:
                if ln < 0:
                    out.append(None)
                    continue
                out.append(payloads[r][pos:pos + ln])
                pos += ln
        self.collective_seconds = comm.seconds
        return out
