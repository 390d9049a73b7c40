#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Usage: python3 chip_smoke.py      (from the root of a checkout; one card)

Phases, in order; any failure raises and the script exits non-zero:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: the eleven CUDA kernel sources (pass 1, inflate_v2,
   inflate_static, dyn_tables, assemble_rows, resolve, match_l6,
   match_v2, select, emit, checksums), from
   csrc/ with one nvcc each, all started together (build/kernels/);
3. pass 1 (the segment route's kernels) against its plain PyTorch
   version, both on the card, at the 64 KiB out_cap: zlib streams of
   every test-corpus kind and level, multi-block, garbage, truncated and
   bit-flipped streams, 16 KiB slices of the Silesia-like corpus, and
   streams with sync points (Z_SYNC_FLUSH and Z_FULL_FLUSH every few KiB,
   stored data holding 00 00 FF FF, truncated and bit-flipped ones),
   and streams whose final stored block is cut by one byte (every one
   BAD); tokens and stats equal; the cut streams through
   BatchDecompressor(use_device=True) in both resolve modes: each None,
   counted as a pass-1 fallback; then again on the main path's 256
   zlib-6 slices, which give the kernel's timed record and its bound;
4. compress: BatchCompressor(level=6, use_device=True) over the corpus
   in 1 MiB items, every output checked with zlib; the match kernel, the
   table kernel and the assembly kernel must each have launched once a
   device pass (their records' launches), and so must the select
   kernel (run extension, lazy demotion, selection and histograms) and
   the emit kernel (the tokens coded and bit-packed into rows);
   the first N_CPU_ITEMS items
   again with device="cpu" (the match finder's plain version), equal
   bytes;
5. decompress: BatchDecompressor(use_device=True, resolve="device") on
   the compressed items and on 256 zlib-6 streams of 64 KiB slices,
   byte-exact with no host fallback, the resolve kernel launched in
   each;
6. the pass-1 kernel's launch count over phases 4-5 must be positive;
   the segment route's counts on the L6 items must show more than 17
   segments and no serial rerun; the resolve kernel's count over them
   likewise;
7. pass 1 alone on the 17 L6 items and on the 256 slices, timed by
   CUDA events with its byte bound and peak memory: the segment route
   and the serial route (the same kernels with sync stops off, one
   segment per stream), in turns, equal;
8. pass-1 kernel against plain version again at the 1 MiB out_cap of
   the L6 items (after the count is read), on a prefix of an L6 item of
   phase 4, a whole small L6 item, streams at the cap, the sync-point
   streams, and the small and bit-flipped cases of phase 3;
9. inflate_v2 against its plain version at its 64 KiB caps: corpus
   slices at zlib levels 1, 6 and 9, stored and Z_FIXED slices,
   bit-flipped streams, the small cases, a stream over the input cap
   and one whose output passes the output cap; every output word equal;
   likewise on the hand-built edge rows of tests/_port_corpus.py; then
   again on the small-batch path's 7 zlib-6 slices, which give the
   kernel's timed record and its bound; the kernel alone on the first of
   them (a batch of 1, the per-request case: equal to its row of the 7)
   and on 256 zlib-6 slices (two waves: one block per SM), and beside
   pass 1 on the 7 slices;
10. the small-batch path: BatchDecompressor(use_device=True) in the
   three formats on batches of 1 and 7 zlib-6 slices, byte-exact with
   no host fallback; inflate_v2's launch count over it must be positive
   and pass 1's zero;
11. inflate_static against its plain version: stored and Z_FIXED
   slices, dynamic, truncated and bit-flipped streams, and the edge
   rows; every output word equal; then again on the static path's 128
   Z_FIXED slices, which give the kernel's timed record and its bound;
12. the static path: inflate_device_static on 128 Z_FIXED slices,
   byte-exact; inflate_static's launch count over it must be positive;
13. the level 0, 1 and 4 compress tiers: BatchCompressor(level=L,
   use_device=True) over the corpus in 1 MiB items (64 KiB blocks),
   every output checked with zlib, ratio and wall per level (two runs);
   the first two items again with device="cpu", equal bytes; at L1 and
   L4 the match_v2, assembly, select and emit kernels launched once a
   device pass, at L4 the table kernel too, at L0 none of them; then
   the first 256 64 KiB slices compressed at levels 0, 1 and 4 for
   phases 14-16 (match_v2 launched again);
14. their two-pass decode (no match_v2 launch in phases 14-16):
   BatchDecompressor(use_device=True,
   resolve="device") on the L1 and L4 items and on the level-0 streams
   of the first 256 64-KiB slices, byte-exact; every host fallback is
   "in_cap" of a stream over 1 MiB; pass 1 and the resolve kernel
   launched on each set; the segment route's counts on the L1 and L4
   items;
15. their small batches: batches of 1 and 7 L1 and L4 slices within the
   64 KiB input cap through BatchDecompressor(use_device=True),
   byte-exact with no host fallback; inflate_v2 launched, pass 1 not;
16. the static kernel on the port's own level-1 output:
   inflate_device_static on the first 128 L1 slices within its input
   cap, byte-exact, inflate_static launched; the same rows held to its
   plain version word for word;
17. the device checksums through the checksum kernel: crc32_device and
   adler32_device of the whole corpus (two walls on the host clock, the
   first the kernel path's first call of the process), crc32_blocks and
   adler32_blocks of its 64 KiB blocks, equal to zlib, timed;
18. the memory budget of one device pass (budget.py): the one-pass peak
   (torch.cuda.max_memory_allocated) per unit byte of the static, L4
   and L6 compress tiers and of the two-pass decode (resolve on the
   card) on the corpus, each within budget.PEAK_PER_BYTE; then one L6
   compress_batch and one device-resolve decode of the corpus items
   repeated until one pass would need BUDGET_OVER x the card's memory
   at the peaks just measured: 2 or more passes, every item equal to
   its single compress, every decode byte-exact, no host fallback;
19. ShardedCompressor at NCCL world size 1 on the corpus: the static
   tier in the three formats, the dynamic tier and the static
   compress_batch over the items, equal to the single-card tiers and
   round-tripping through zlib; walls and collective times; the
   checksum kernel's launches counted from 0 over it: 2 a budget pass
   (crc32_blocks and adler32_blocks) in each of the static zlib and
   gzip runs, none in the others (its record's launches);
20. N_RANKS gloo ranks on the one card, child processes of this script
   (`--gloo-rank`) with a timeout: the same bytes as phase 19, and
   compress_global in gzip gunzips to the corpus; then the first 16 KiB
   of the 256 slices (each a whole 64 KiB out_cap row on the card, a
   quarter of the bytes on the host, where each rank holds every
   decoded stream) repeated through ShardedDecompressor (resolve on the
   card) until the ranks together would need BUDGET_OVER x the card's
   memory in one pass each: the ranks count each other on the card
   (budget.SHARERS), each runs 2 or more passes, every stream
   byte-exact;
21. ShardedDecompressor on the 256 zlib-6 slices at NCCL world size 1
   (in this process) and at N_RANKS gloo ranks (in phase 20's ranks),
   host and device resolve: every stream within the 64 KiB input cap
   byte-exact, the others None; pass 1 launched;
22. the table kernel (dyn_tables, two warps a histogram) against its
   plain version (the Python builder) on the histograms of the corpus's
   259 L6 and 259 L4 blocks, seeded tie-heavy histograms and edge cases:
   all four outputs equal; then timed on the L6 blocks' histograms, with
   its byte bound;
23. the assembly kernel against its plain versions on the card, in its
   three modes (assemble, place_rows, join_rows), on the device rows of
   an L1, an L4 and an L6 pass over the corpus items and a 64 KiB random
   item (its block stored): streams, byte counts and joined bytes equal;
   then timed on the L6 pass of the corpus items (the main path's
   shape), whose joined streams must be phase 4's outputs: the record's
   ms is assemble's one launch (no host sync), and the whole `assemble`
   call with its sync is logged beside it; the bound counts the row
   bytes that hold bits, not the rows' padded width;
24. the resolve kernel (pass 2) against its plain version on the card:
   pass 1's tokens of the 256 slices, the 17 L6 items and 1 MiB of one
   byte at zlib-6 (the strided view the decoder hands over, with and
   without pass 1's token counts), the hand-built and edge columns of
   tests/_port_corpus.py (resolve_cases, a 1 MiB chain of distance-4
   matches among them), T == 0 and B == 0: outlen, ok and the bytes
   [0, outlen) of every ok row equal; then timed on the L6 items'
   tokens (the record) and the slices', with the counts as the decoder
   passes them, beside the plain version on the card, and each of the
   call's kernels' device time (torch.profiler) logged beside it; the
   bound counts the real tokens (stats[:, 3]), not the padded columns;
25. the match kernel (match_l6, the L6 match finder) against its plain
   version on the card: the 259 windows of the L6 pass over the corpus
   items (the main path's shape), zeros and random windows of that
   width, and the trap windows of tests/_port_corpus.py l6_windows (the
   rank rule, hist_start, distances 32,767-32,769, the tail and padding,
   ties, the decay, a first block, a short last block) in 16 KiB
   blocks: ml and dist equal; then timed on the 259 windows (the
   record) beside the plain version on the card; the bound counts the
   window rows in and (ml, dist) out;
26. the select kernel (run extension, the L6 history mask and lazy
   demotion, greedy selection, the histograms) against its plain
   version on the card: the match kernel's (ml, dist) of the L6 pass's
   259 windows, of zeros and random windows and of the trap windows;
   the L4 pass's windows (find_matches_v2) at the L4 and L1 flags
   (cells of 64, with and without histograms); the seeded edge arrays
   of tests/_port_corpus.py select_cases and the tile-edge arrays of
   its select_tile_cases (chains, runs, long matches, valid_len and
   lazy-demotion pairs at the kernel's tile edges and halo ends) at
   the three callers' flags: ml, sel, lit, ll_hist and of_hist equal;
   then timed on the 259 L6 windows (the record) beside the plain
   version on the card, and on one L1 per-item pass's 16 windows and
   the L4 pass's windows; the bound counts the payload's (ml, dist)
   and bytes in, (ml, sel, lit) and the histograms out;
27. the surface the examples and tools use: (a) ops.resolve.
   resolve_tokens_device on pass 1's token columns of the 256 slices at
   the 64 KiB out_cap, every output its slice, one resolve-kernel launch,
   equal to the plain version on the card, timed beside resolve_batch;
   (b) the nine examples/torch_*.py, each its own process on the card
   (the two distributed ones as 2 gloo ranks sharing it), all started
   together, each with its own timeout, every one exiting 0; (c)
   utils.profiling.device_trace around one L6 compress_batch of a 1 MiB
   item inside trace("l6_item"): the Chrome trace file names the span
   and a match- or select-kernel launch;
28. the emit kernel (every lane's token coded through the block's tables
   or the static codes, and bit-packed into rows) against its plain
   version on the card: the L6 pass's 259 blocks, the L4 pass's, one L1
   per-item pass's (static mode), zeros and random blocks at L6 and L1,
   and the seeded trap, overflowing and tile-edge arrays of
   tests/_port_corpus.py (emit_cases, emit_random_cases,
   emit_chunk_cases) in both modes, as they are and through
   emit_unaligned (every row off 16 bytes): rows (every padding byte),
   byte_off, row_bit0 and end_bits equal; the launch shape on the three
   passes (lanes a tile, blocks, blocks resident an SM, registers,
   shared memory); then timed on the L6
   pass (the record) beside the plain version on the card, and on the
   L4 and L1 passes; the bound counts what this run's tokens need: every
   lane's sel flag, the lit flag of each lane not sel, the byte of each
   literal, int64 (ml, dist) of each sel lane, and each row's buffer and
   two int64 out;
29. the L1-5 match kernel (match_v2: find_matches_v2 on the card)
   against its plain version on the card: the L4 pass's 259 blocks,
   one L1 per-item pass's 16 blocks, zeros and random blocks, and the
   seeded trap blocks of tests/_port_corpus.py (v2_cases, at block
   sizes 1 to 100,000, the collision traps of its sort by hash
   included; the traps again in batches that take 8-block clusters):
   ml and dist equal at every position; no window of the L4 and L1
   passes takes the sort by the whole word, each escape trap's windows
   do (the kernel's escape count); the launch shapes of both passes
   logged; then timed on the L4 pass (the record) beside the plain
   version on the card, and on the L1 pass; the bound counts each
   block's bytes and the 7 its last words read, valid_len, and int64
   (ml, dist) out;
30. the checksum kernel (csrc/checksums.cu: CRC-32 and Adler-32 of rows
   or of one buffer) against its plain versions on the card: the
   corpus's 259 rows of 64 KiB with int32 lengths (phase 19's call),
   the trap rows of tests/_port_corpus.py (checksum_rows at widths
   1,024, 5,120 and 65,536: every CRC span edge and an Adler group
   edge of every thread +-1, zlib's NMAX multiples, the head and tail
   lengths, all-0x00 and all-0xFF rows; int32 and int64 lengths), its
   rows wider than a tile (checksum_wide_rows: the CRC register
   carried, Adler's tile terms added by atomics; again after a narrow
   batch), all-0xFF rows of one to three tiles, rows at an odd stride
   and the corpus as the compress items' 17 rows of 1 MiB, and its trap
   buffers (checksum_buffers, 1 MiB + 3 bytes among them) at its trap
   initial values, the whole corpus with and without an initial value,
   a buffer twice in a row and on two streams: every register equal,
   and equal to zlib, every state left zeroed; the corpus as one buffer
   timed, each checksum one kernel launch (torch.profiler); then
   crc32_blocks and adler32_blocks timed on the corpus's rows beside
   their plain versions on the card (the record: the pair summed; the
   bound the bytes each call must move: the corpus bytes, the int32
   lengths and the int64 registers), and on the 17 rows of 1 MiB.

Phases 13-21 drive the level 0-5 tiers, the checksums, the memory
budget and the sharded paths; the kernels' launches there are logged
and asserted, and their records stay those of phases 3-12, 22-26 and
28-30.
Each kernel's record (ms, plain_ms, bound_ms) is taken on its path's
own inputs, where every input and output byte is needed: the bound is
those bytes over the card's memory rate. The last two lines are the
kernels' JSON record and the result JSON. The script exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import datetime
import gzip
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _port_corpus import (cut_stored_streams, edge_cases,  # noqa: E402
                          edge_rows, make_corpus, mutated_streams, raw_z)

ITEM = 1 << 20          # compress item size (bytes)
SLICE = 65536           # decode-set slice size (bytes)
N_SLICES = 256          # zlib-6 decode set
N_CHECK_SLICES = 32     # corpus slices in the kernel-vs-plain set
CHECK_SLICE = 16384     # corpus bytes per stream of the mixed check sets:
                        # their plain runs last as long as their longest
                        # stream; each path's record takes full slices
N_MUTATED = 96          # bit-flipped streams in the kernel-vs-plain set
L6_PREFIX = 28 << 10    # bytes of an L6 item in the 1 MiB kernel-vs-plain set
MUTATED = object()      # marks a case held only to the plain version
KERNEL_REPS = 5
N_V2_SLICES = 32        # corpus slices in the inflate_v2 check set
N_V2_MUTATED = 64       # bit-flipped streams in the stream-kernel check sets
N_SMALL = (1, 7)        # small-batch path batch sizes
N_STATIC = 128          # Z_FIXED slices through inflate_device_static
HBM_BYTES_PER_MS = 3.35e9   # H100 SXM device memory, 3.35 TB/s
KERNELS = ("inflate_tokens", "inflate_v2", "inflate_static", "dyn_tables",
           "assemble_rows", "resolve", "match_l6", "match_v2", "select",
           "emit", "checksums")
TIER_LEVELS = (0, 1, 4)     # the stored, static and dynamic compress tiers
N_CPU_ITEMS = 2             # items also compressed with device="cpu"
BUDGET_OVER = 1.2           # phases 18, 20: one-pass need / card memory
N_RANKS = 2                 # phase 20: gloo ranks on the one card
N_TIE_HISTS = 512           # phase 22: seeded tie-heavy histograms
RANK_TIMEOUT = 300          # seconds for phase 20's ranks
RENDEZVOUS = 120            # seconds a phase 20 rank waits for the other


def log(msg: str) -> None:
    print(msg, flush=True)


def corpus() -> bytes:
    """The Silesia-like corpus (generated once into benches/corpus/)."""
    d = os.path.join(ROOT, "benches", "corpus")
    if not os.path.isdir(d) or not os.listdir(d):
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import gen_silesia_like
        with contextlib.redirect_stdout(sys.stderr):
            gen_silesia_like.generate(d)
    return b"".join(open(os.path.join(d, n), "rb").read()
                    for n in sorted(os.listdir(d)))


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from libdeflate_rsx_tpu_torch.ops import _build
    t0 = time.perf_counter()
    for name in KERNELS:
        _build.load(name)
    dt = time.perf_counter() - t0
    log(f"build: {', '.join(KERNELS)} loaded in {dt:.2f} s (nvcc, in "
        f"parallel: " + ", ".join(f"{n} {_build.BUILD_SECONDS.get(n, 0.0):.2f} s"
                                  for n in KERNELS) + ")")
    for name in KERNELS:
        report = _build.library_path(name) + ".log"
        if os.path.exists(report):
            for line in open(report).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: " + line.strip())
    return dt


def small_cases():
    """(stream, original, or None for malformed, or MUTATED) of every
    test-corpus kind and level, multi-block, garbage, truncated (the
    final stored block cut by one byte among them) and bit-flipped
    streams."""
    cases = []
    for lvl in (0, 1, 6, 9):
        for kind in ("text", "random", "pattern", "zeros", "periodic:7"):
            d = make_corpus(kind, 3000 + 37 * lvl, seed=lvl)
            cases.append((raw_z(d, lvl), d))
    d = make_corpus("text", 5000, seed=3)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    multi = (co.compress(d[:2000]) + co.flush(zlib.Z_FULL_FLUSH)
             + co.compress(d[2000:]) + co.flush())
    cases += [(multi, d), (raw_z(b"x"), b"x"), (raw_z(b""), b"")]
    r = random.Random(11)
    good = make_corpus("text", 3000, seed=1)
    cases += [(bytes(r.randrange(256) for _ in range(600)), None),
              (raw_z(good)[:250], None), (b"\x07\x00", None)]
    cases += [(z, None) for z, _ in cut_stored_streams()]
    return cases + [(m, MUTATED) for m in mutated_streams(N_MUTATED)]


def sync_cases(data: bytes):
    """(stream, original, or None for malformed, or MUTATED) with sync
    points: corpus slices at zlib-6 with a Z_SYNC_FLUSH every 2 KiB
    (matches reach back across them) or a Z_FULL_FLUSH every 4 KiB,
    stored and zlib-6 slices holding 00 00 FF FF every 509 bytes (false
    candidates), a stream cut in its third segment, and bit-flipped
    copies."""
    def flushed(d, every, level=6, mode=zlib.Z_SYNC_FLUSH):
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        out = b""
        for k in range(0, len(d), every):
            out += co.compress(d[k:k + every])
            if k + every < len(d):
                out += co.flush(mode)
        return out + co.flush()

    cases = []
    for i in range(3):
        c = data[(60 + i) * SLICE:(60 + i) * SLICE + CHECK_SLICE]
        cases.append((flushed(c, 2048), c))
    c = data[63 * SLICE:63 * SLICE + CHECK_SLICE]
    cases.append((flushed(c, 4096, mode=zlib.Z_FULL_FLUSH), c))
    c = data[64 * SLICE:64 * SLICE + CHECK_SLICE]
    marked = b"".join(c[k:k + 505] + b"\x00\x00\xff\xff"
                      for k in range(0, len(c), 505))
    cases += [(flushed(marked, 4096, level=0), marked),
              (flushed(marked, 4096), marked)]
    cases.append((cases[0][0][:len(cases[0][0]) // 3], None))
    r = random.Random(13)
    for k in range(8):
        s = bytearray(cases[k % 6][0])
        for _ in range(1 + k % 3):
            bit = r.randrange(8 * len(s))
            s[bit >> 3] ^= 1 << (bit & 7)
        cases.append((bytes(s), MUTATED))
    return cases


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def counting_phases():
    """Counts the encode flows' phase ends while open (one "assemble"
    and, at L4-9, one "tables" a device compress pass)."""
    import collections
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    counts = collections.Counter()
    old, gs.PHASE_END = gs.PHASE_END, lambda name: counts.update([name])
    try:
        yield counts
    finally:
        gs.PHASE_END = old


def kernel_vs_plain(cases, out_cap: int, label: str):
    """Run the kernel and the plain version on the card on the same
    streams at one out_cap; tokens and stats must be equal, and every
    well-formed stream must decode, through pass 2, to its bytes.
    Returns (max abs err, kernel ms, plain ms, stats)."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch

    streams = [c for c, _ in cases]
    args = it.pack_streams(streams, it.in_cap_bucket(streams), "cuda")[:3]
    tok_k, st_k = it.pass1(*args, out_cap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok_p, st_p = it.pass1_plain(*args, out_cap)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((tok_k.long() - tok_p.long()).abs().max()),
              int((st_k.long() - st_p.long()).abs().max()))
    if not (torch.equal(tok_k, tok_p) and torch.equal(st_k, st_p)):
        bad = (st_k != st_p).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: kernel != plain (max abs err {err});"
                             f" stats differ for streams {bad[:10]}")
    stats = st_k.cpu().numpy()
    ntok = max(1, int(stats[:, 3].max()))
    out, outlen, ok = resolve_batch(tok_k[:, :ntok], out_cap)
    for i, (_, want) in enumerate(cases):
        done = stats[i, 0] == it.DONE
        if want is MUTATED:
            continue
        if want is None:
            assert not done, f"{label}: malformed stream {i} decoded as DONE"
            continue
        assert done and bool(ok[i]), f"{label}: stream {i} not decoded"
        got = out[i, :stats[i, 1]].cpu().numpy().tobytes()
        assert got == want, f"{label}: stream {i} bytes"
    del out, tok_p
    ms = time_cuda(lambda: it.pass1(*args, out_cap), KERNEL_REPS)
    return err, ms, plain_ms, stats


def phase_kernel(data: bytes):
    """Kernel against plain version on the card at the 64 KiB out_cap of
    the slice decode set, then on the main path's N_SLICES zlib-6 slices;
    returns the kernel's JSON record, from the latter."""
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    sync = sync_cases(data)
    cases = small_cases() + sync
    for i in range(N_CHECK_SLICES):
        c = data[i * SLICE:i * SLICE + CHECK_SLICE]
        cases.append((raw_z(c), c))
    counts = route_counts()
    err, ms, plain_ms, stats = kernel_vs_plain(cases, SLICE, "64 KiB")
    n_mut = int((stats[-N_CHECK_SLICES - len(sync) - N_MUTATED:
                       -N_CHECK_SLICES - len(sync), 0] == it.DONE).sum())
    log(f"kernel vs plain, out_cap 64 KiB: equal on {len(cases)} streams "
        f"({N_CHECK_SLICES} corpus slices of {CHECK_SLICE} B at zlib-6, "
        f"{len(sync)} with sync points, "
        f"{N_MUTATED} bit-flipped streams of which {n_mut} DONE, "
        f"{len(cases) - N_CHECK_SLICES - len(sync) - N_MUTATED} small "
        f"cases), max abs err {err}; route counts over its first call: "
        f"{route_counts(counts)}")
    log(f"  pass-1 kernel {ms:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); plain version {plain_ms:.1f} ms "
        f"(host clock, one run), on that same reduced set")
    cut = cut_stored_streams()
    for resolve in ("device", "host"):
        bd = BatchDecompressor(use_device=True, resolve=resolve)
        got = bd.decompress_batch([z for z, _ in cut],
                                  [len(d) for _, d in cut])
        assert got == [None] * len(cut), \
            f"a cut stored stream decoded (resolve={resolve})"
        assert dict(bd.fallbacks) == {"pass1": len(cut)}, bd.fallbacks
    log(f"  {len(cut)} streams whose final stored block is cut by one byte:"
        f" BAD in the kernel as in the plain version; None through "
        f"BatchDecompressor in both resolve modes, each a pass-1 fallback")
    chunks = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    path = [(raw_z(c), c) for c in chunks]
    err2, ms, plain_ms, stats = kernel_vs_plain(path, SLICE, "256 slices")
    nbytes = pass1_bytes([z for z, _ in path], stats)
    log(f"kernel vs plain on the main path's {N_SLICES} zlib-6 slices: "
        f"equal, max abs err {err2}; pass-1 kernel {ms:.3f} ms per launch "
        f"(CUDA events, {KERNEL_REPS} launches); plain version "
        f"{plain_ms:.1f} ms (host clock, one run)")
    return record("inflate_tokens", "ops/pallas/inflate_tokens.py:315",
                  max(err, err2), ms, plain_ms, nbytes)


def route_counts(since=None) -> dict:
    """The segment route's counts (ops/inflate_tokens.py), or their
    growth since an earlier reading."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    now = {k: getattr(it, k) for k in ("SEGMENTS", "FALSE_CANDIDATES",
                                        "CONFIRMED", "RERUNS")}
    return now if since is None else {k: now[k] - since[k] for k in now}


def pass1_bytes(streams, stats) -> int:
    """Bytes pass 1 must move: each stream byte, offset and length read
    once; each token and stats row written once."""
    return sum(len(z) + 12 for z in streams) + 4 * int(stats[:, 3].sum()) \
        + 16 * len(streams)


def phase_pass1_routes(streams, out_cap: int, label: str):
    """Pass 1 alone on one batch of the main path: the segment route and
    the serial route (sync stops off), equal, timed by CUDA events in
    turns (segment, serial, serial, segment), with the byte bound and
    peak memory of the segment route."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams(streams, it.in_cap_bucket(streams), "cuda")[:3]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    counts = route_counts()
    tok, st = it.pass1(*args, out_cap)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    counts = route_counts(counts)
    routes = {"segment": {}, "serial": {"_sync_stops": False}}
    tok2, st2 = it.pass1(*args, out_cap, _sync_stops=False)
    assert torch.equal(tok, tok2) and torch.equal(st, st2), \
        f"{label}: the serial route differs from the segment route"
    del tok2, st2
    order = ("segment", "serial", "serial", "segment")
    t = {k: [] for k in routes}
    for name in order:
        t[name].append(time_cuda(lambda: it.pass1(*args, out_cap,
                                                  **routes[name]),
                                 KERNEL_REPS))
    stats = st.cpu().numpy()
    nbytes = pass1_bytes(streams, stats)
    ntok = int(stats[:, 3].sum())
    log(f"pass 1 on {label}: {ntok} tokens; segment route "
        f"{t['segment'][0]:.3f} / {t['segment'][1]:.3f} ms, serial route "
        f"{t['serial'][0]:.3f} / {t['serial'][1]:.3f} ms per call (CUDA "
        f"events, {KERNEL_REPS} calls each, in turns); equal; "
        f"{1e6 * sum(t['segment']) / 2 / max(ntok, 1):.2f} ns per token; "
        f"bound {nbytes / HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes); peak "
        f"memory of one call {peak / 2**20:.1f} MiB; route counts {counts}")


def record(name, replaces, err, ms, plain_ms, nbytes):
    """A kernel's JSON record (launches are filled in from its path).
    bound_ms: the bytes it must move over the card's memory rate; it
    does no arithmetic that a rate bounds."""
    log(f"  {name}: bound {nbytes / HBM_BYTES_PER_MS:.6f} ms "
        f"({nbytes} bytes at 3.35 TB/s)")
    return {"name": name, "route": "cuda",
            "source": f"libdeflate_rsx_tpu_torch/csrc/{name}.cu",
            "replaces": "libdeflate_rsx_tpu/" + replaces,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_MS,
            "bound_by": "bytes", "library_ms": None}


def phase_kernel_items(data: bytes, comp: list[bytes]):
    """Kernel against plain version at the L6 items' out_cap (1 MiB):
    the first L6 item cut to its first L6_PREFIX bytes (past its first
    block and the SYNC join, then truncated: BAD), a whole two-block L6
    item of the port, 1 MiB of zeros (DONE at the cap) and one byte more
    (BAD at the cap), and the small and bit-flipped cases. A whole
    1 MiB item is ~555k serial steps for the plain version, so the set
    is cut to a prefix. Returns the max abs err."""
    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    two = data[:SLICE + 4096]
    two_c = BatchCompressor(level=6, use_device=True,
                            device="cuda").compress_batch([two])[0]
    zeros = bytes(ITEM)
    sync = sync_cases(data)
    cases = [(comp[0][:L6_PREFIX], None), (two_c, two),
             (raw_z(zeros), zeros), (raw_z(zeros + b"\x00"), None)]
    cases += sync + small_cases()
    err, ms, plain_ms, stats = kernel_vs_plain(cases, ITEM, "1 MiB")
    assert stats[3, 0] == it.BAD and stats[3, 1] > ITEM - 258, stats[3]
    log(f"kernel vs plain, out_cap 1 MiB: equal on {len(cases)} streams "
        f"(a {L6_PREFIX}-byte prefix of L6 item 0 decoding {stats[0, 1]} "
        f"bytes in {stats[0, 3]} tokens, a two-block L6 item, 1 MiB of "
        f"zeros and one byte more, {len(sync)} with sync points, "
        f"{len(cases) - 4 - len(sync)} small and bit-flipped cases), "
        f"max abs err {err}")
    log(f"  pass-1 kernel {ms:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); plain version {plain_ms:.1f} ms "
        f"(host clock, one run), on that same reduced set")
    return err


def phase_compress(data: bytes):
    import torch
    from libdeflate_rsx_tpu_torch import BatchCompressor

    items = [data[i:i + ITEM] for i in range(0, len(data), ITEM)]
    bc = BatchCompressor(level=6, use_device=True, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = bc.compress_batch(items)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, (it_, c) in enumerate(zip(items, comp)):
        assert zlib.decompress(c, -15) == it_, f"item {i} round trip"
    ratio = len(data) / sum(len(c) for c in comp)
    log(f"compress: {len(items)} items of <= 1 MiB ({len(data)} bytes) "
        f"round-trip through zlib; ratio {ratio:.4f}; wall {dt:.3f} s")
    return items, comp


def phase_compress_cpu(items, comp):
    """The first N_CPU_ITEMS L6 items again with device="cpu", where the
    match finder runs its plain version: equal bytes."""
    from libdeflate_rsx_tpu_torch import BatchCompressor

    t0 = time.perf_counter()
    cpu = BatchCompressor(level=6, use_device=True, device="cpu") \
        .compress_batch(items[:N_CPU_ITEMS])
    assert cpu == comp[:N_CPU_ITEMS], "L6: card bytes != CPU bytes"
    log(f"compress L6: the first {N_CPU_ITEMS} items on the CPU equal the "
        f"card's ({time.perf_counter() - t0:.2f} s)")


def phase_decompress(name, streams, originals, caps):
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    bd = BatchDecompressor(use_device=True, resolve="device", device="cuda")
    run = rs.LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bd.decompress_batch(streams, caps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [i for i, (g, w) in enumerate(zip(got, originals)) if g != w]
    assert not bad, f"{name}: items {bad[:10]} not byte-exact"
    assert not bd.fallbacks, f"{name}: host fallbacks {dict(bd.fallbacks)}"
    run = rs.LAUNCHES - run
    assert run > 0, f"{name}: the resolve kernel never launched"
    log(f"decompress {name}: {len(streams)} streams, "
        f"{sum(map(len, originals))} bytes byte-exact, host fallbacks "
        f"{dict(bd.fallbacks)}; resolve launches {run}; wall {dt:.3f} s")


def fixed_z(data: bytes) -> bytes:
    """zlib's raw-DEFLATE stream of data in static-Huffman blocks."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    return co.compress(data) + co.flush()


def stream_kernel_vs_plain(mod, name, cases, label):
    """A stream kernel (inflate_v2 or inflate_static) and its plain
    version on the card on the same streams: every output word equal,
    and every stream with known bytes decoding to them. Returns (max abs
    err, kernel ms, plain ms, out words numpy)."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    lens, words = v2.pack([c for c, _ in cases], "cuda")
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")
    out_k = kernel(lens, words)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = plain(lens, words)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((out_k.long() - out_p.long()).abs().max())
    if not torch.equal(out_k, out_p):
        bad = (out_k != out_p).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{label}: kernel != plain (max abs err {err}) "
                             f"for streams {bad[:10]}")
    out = out_k.cpu().numpy()
    for i, (_, want) in enumerate(cases):
        n = int(out[i, -1])
        if want is None:
            assert n < 0, f"{label}: malformed stream {i} decoded"
        elif want is not MUTATED:
            assert out[i].view("<u1")[:max(n, 0)].tobytes() == want, \
                f"{label}: stream {i} bytes (count {n})"
    del out_p
    ms = time_cuda(lambda: kernel(lens, words), KERNEL_REPS)
    return err, ms, plain_ms, out


def stream_bytes(name, streams, originals) -> int:
    """Bytes a stream kernel must move for streams that decode to their
    originals: each stream byte and length read once, each decoded byte
    and the trailer words (inflate_v2: flags and count; inflate_static:
    count) written once."""
    trailer = 8 if name == "inflate_v2" else 4
    return sum(len(z) + 4 + trailer for z in streams) \
        + sum(map(len, originals))


def edge_vs_plain(mod, name):
    """A stream kernel and its plain version on the card on the
    hand-built edge rows (tests/_port_corpus.edge_cases: rows filled to
    their last byte, bits read past the row, bytes past a stream's end,
    distances 31-33, 64 and 32,768, 15-bit codes): every output word
    equal. Returns the max abs err."""
    import torch
    cases = edge_cases()
    lens, words = (torch.from_numpy(a).cuda() for a in edge_rows(cases))
    out_k = getattr(mod, name)(lens, words)
    out_p = getattr(mod, name + "_plain")(lens, words)
    err = int((out_k.long() - out_p.long()).abs().max())
    if not torch.equal(out_k, out_p):
        bad = (out_k != out_p).any(dim=1).nonzero().flatten().tolist()
        raise AssertionError(f"{name} edge rows: kernel != plain (max abs err "
                             f"{err}) for {[cases[i][0] for i in bad]}")
    n_ok = int((out_k[:, -1] >= 0).sum())
    log(f"{name} vs plain on {len(cases)} edge rows: equal ({n_ok} decode), "
        f"max abs err {err}")
    return err


def stream_record(mod, name, replaces, streams, originals, err, label):
    """The stream kernel's record on its path's own inputs: streams that
    each decode to their original within the caps, so every input and
    output byte is needed. `err` is the check set's max abs err."""
    err2, ms, plain_ms, _ = stream_kernel_vs_plain(
        mod, name, list(zip(streams, originals)), label)
    nbytes = stream_bytes(name, streams, originals)
    log(f"  {label}: equal, max abs err {err2}; {name} kernel {ms:.3f} ms "
        f"per launch (CUDA events, {KERNEL_REPS} launches); plain version "
        f"{plain_ms:.1f} ms (host clock, one run)")
    return record(name, replaces, max(err, err2), ms, plain_ms, nbytes)


def stream_cases():
    """The small cases of every corpus kind and level, with the garbage
    and truncated ones held only to the plain version (a static decoder
    may read garbage as a block), and bit-flipped streams: shared by the
    two stream kernels' check sets."""
    cases = [(c, MUTATED if w is None else w) for c, w in small_cases()
             if w is not MUTATED]
    return cases + [(m, MUTATED) for m in mutated_streams(N_V2_MUTATED,
                                                          seed=7)]


def phase_v2_kernel(data: bytes):
    """inflate_v2 against its plain version at its 64 KiB caps and on the
    edge rows; then the kernel alone on a batch of 1 and on the 256
    zlib-6 slices, and beside pass 1 on the small path's 7 slices.
    Returns its JSON record."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    cases = []
    for i in range(N_V2_SLICES):
        c = data[i * SLICE:i * SLICE + CHECK_SLICE]
        z = raw_z(c, (1, 6, 9)[i % 3])
        cases.append((z, c if len(z) <= v2.IN_CAP else None))
    for i in range(2):
        c = data[(40 + i) * SLICE:(40 + i) * SLICE + CHECK_SLICE]
        cases += [(raw_z(c, 0), c), (fixed_z(c), c)]
    over_in = bytes(random.Random(1).randrange(256) for _ in range(SLICE))
    big = data[:4096] * 18      # output past the cap in few (long) matches
    cases += [(raw_z(over_in, 0), None), (raw_z(big), None)]
    cases += stream_cases()
    err, ms, plain_ms, out = stream_kernel_vs_plain(
        v2, "inflate_v2", cases, "inflate_v2")
    assert out[-len(stream_cases()) - 1, -2] & v2.BAD_OUT_CAP
    n_ok = int((out[:, -1] >= 0).sum())
    log(f"inflate_v2 vs plain: equal on {len(cases)} streams "
        f"({N_V2_SLICES} corpus slices of {CHECK_SLICE} B at zlib 1/6/9, 2 "
        f"stored and 2 Z_FIXED slices of as many bytes, one over the input "
        f"cap, one whose "
        f"output passes the cap, {N_V2_MUTATED} bit-flipped, "
        f"{len(cases) - N_V2_SLICES - 6 - N_V2_MUTATED} small cases; "
        f"{n_ok} decode), max abs err {err}")
    log(f"  inflate_v2 kernel {ms:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); plain version {plain_ms:.1f} ms (host "
        f"clock, one run), on that same set")
    err = max(err, edge_vs_plain(v2, "inflate_v2"))
    originals = small_batch_slices(data)
    seven = [raw_z(c) for c in originals]
    rec = stream_record(v2, "inflate_v2", "ops/pallas/inflate_v2.py:60",
                        seven, originals, err,
                        f"the small-batch path's {len(seven)} slices")
    # the per-request case: the first of those slices alone, equal to its
    # row of the batch of 7 (held to the plain version above)
    lens, words = v2.pack(seven, "cuda")
    row0 = v2.inflate_v2(lens, words)[0]
    one = (lens[:1].contiguous(), words[:1].contiguous())
    assert torch.equal(v2.inflate_v2(*one)[0], row0), "batch of 1 != batch of 7"
    ms1 = time_cuda(lambda: v2.inflate_v2(*one), KERNEL_REPS)
    nb1 = stream_bytes("inflate_v2", seven[:1], originals[:1])
    log(f"  inflate_v2 kernel on a batch of 1 zlib-6 slice (the per-request "
        f"case): {ms1:.3f} ms per launch (CUDA events, {KERNEL_REPS} "
        f"launches); bound {nb1 / HBM_BYTES_PER_MS:.6f} ms; equal to its row "
        f"of the batch of 7")
    slices = [raw_z(data[i * SLICE:(i + 1) * SLICE]) for i in range(N_SLICES)]
    lens, words = v2.pack(slices, "cuda")
    ms256 = time_cuda(lambda: v2.inflate_v2(lens, words), KERNEL_REPS)
    fit = [z for z in slices if len(z) <= v2.IN_CAP]   # the rest pack empty
    moved = sum(len(z) + 12 for z in fit) + len(fit) * SLICE \
        + 12 * (N_SLICES - len(fit))
    log(f"  inflate_v2 kernel on {N_SLICES} zlib-6 slices of 64 KiB ({len(fit)} "
        f"within the input cap): {ms256:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); bound {moved / HBM_BYTES_PER_MS:.6f} ms")
    # the small-batch decoder against pass 1 on the small path's largest
    # batch, in turns: v2, pass 1, pass 1, v2
    lens, words = v2.pack(seven, "cuda")
    args = it.pack_streams(seven, it.in_cap_bucket(seven), "cuda")[:3]
    runs = [lambda: v2.inflate_v2(lens, words),
            lambda: it.pass1(*args, SLICE)]
    t = [time_cuda(runs[k], KERNEL_REPS) for k in (0, 1, 1, 0)]
    log(f"  {len(seven)} zlib-6 slices of 64 KiB: inflate_v2 {t[0]:.3f} / "
        f"{t[3]:.3f} ms, pass-1 kernel (tokens only, out_cap 64 KiB) "
        f"{t[1]:.3f} / {t[2]:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches each, in turns)")
    return rec


def small_batch_slices(data: bytes):
    """The first slices of 64 KiB whose zlib-6 payload fits the
    small-batch decoder's 64 KiB input cap."""
    out = []
    for i in range(len(data) // SLICE):
        c = data[i * SLICE:(i + 1) * SLICE]
        z = raw_z(c)
        if len(z) <= SLICE:
            out.append(c)
        if len(out) == max(N_SMALL):
            return out
    raise AssertionError("too few compressible slices")


def phase_small_batch(data: bytes):
    """The small-batch path: BatchDecompressor(use_device=True) in every
    format on batches of N_SMALL zlib-6 slices."""
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor

    slices = small_batch_slices(data)
    for fmt in ("deflate", "zlib", "gzip"):
        comp = [{"deflate": raw_z, "zlib": zlib.compress,
                 "gzip": gzip.compress}[fmt](c) for c in slices]
        for n in N_SMALL:
            bd = BatchDecompressor(format=fmt, use_device=True, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = bd.decompress_batch(comp[:n], [SLICE] * n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert got == slices[:n], f"small batch {fmt} x{n}: not byte-exact"
            assert not bd.fallbacks, f"small batch {fmt} x{n}: {bd.fallbacks}"
            log(f"small batch {fmt}: {n} slices of 64 KiB byte-exact, host "
                f"fallbacks {{}}; wall {dt * 1e3:.1f} ms")


def static_slices(data: bytes):
    """The first N_STATIC slices of 64 KiB whose Z_FIXED stream fits the
    input cap: (slices, streams)."""
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st

    slices, streams = [], []
    for i in range(len(data) // SLICE):
        c = data[i * SLICE:(i + 1) * SLICE]
        z = fixed_z(c)
        if len(z) <= st.IN_CAP:
            slices.append(c)
            streams.append(z)
        if len(slices) == N_STATIC:
            return slices, streams
    raise AssertionError("too few Z_FIXED slices within the cap")


def phase_static_kernel(data: bytes):
    """inflate_static against its plain version: stored and Z_FIXED
    slices, dynamic, truncated and bit-flipped streams; then on the
    static path's N_STATIC Z_FIXED slices. Returns its JSON record, from
    the latter."""
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st

    cases = []
    for i in range(8):
        c = data[(50 + i) * SLICE:(50 + i) * SLICE + CHECK_SLICE]
        z = raw_z(c)          # bad when its first block is dynamic
        cases += [(raw_z(c, 0), c), (fixed_z(c), c),
                  (z, None if (z[0] >> 1) & 3 == 2 else MUTATED)]
    c = data[:SLICE]
    cases += [(fixed_z(c)[:8000], MUTATED), (raw_z(c, 0)[:30000], None)]
    # the small cases are mostly dynamic: held to the plain version only
    cases += [(z, MUTATED) for z, _ in stream_cases()]
    err, ms, plain_ms, out = stream_kernel_vs_plain(
        st, "inflate_static", cases, "inflate_static")
    log(f"inflate_static vs plain: equal on {len(cases)} streams (8 stored, "
        f"8 Z_FIXED and 8 zlib-6 slices of {CHECK_SLICE} B, 2 truncated, "
        f"{N_V2_MUTATED} bit-flipped, {len(cases) - 26 - N_V2_MUTATED} small "
        f"cases; {int((out[:, -1] >= 0).sum())} decode), max abs err {err}")
    log(f"  inflate_static kernel {ms:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); plain version {plain_ms:.1f} ms (host "
        f"clock, one run), on that same set")
    err = max(err, edge_vs_plain(st, "inflate_static"))
    slices, streams = static_slices(data)
    return stream_record(st, "inflate_static",
                         "ops/pallas/inflate_static.py:40", streams, slices,
                         err, f"the static path's {N_STATIC} Z_FIXED slices")


def phase_static_path(data: bytes):
    """inflate_device_static on N_STATIC Z_FIXED slices, byte-exact."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_device_static

    slices, streams = static_slices(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = inflate_device_static(streams, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert got == slices, "inflate_device_static: not byte-exact"
    log(f"inflate_device_static: {N_STATIC} Z_FIXED slices of 64 KiB "
        f"({sum(map(len, streams))} bytes in) byte-exact; wall "
        f"{dt * 1e3:.1f} ms")


def phase_compress_tiers(data: bytes):
    """BatchCompressor at levels 0, 1 and 4 over the 1 MiB items on the
    card, twice; every output through zlib; the first N_CPU_ITEMS items
    again on the CPU, equal bytes. Returns the items, {level: outputs}
    and match_v2's launches over the L1 and L4 runs."""
    import torch
    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.ops import assemble as asm
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dtab
    from libdeflate_rsx_tpu_torch.ops import emit as em
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops import select as sl

    items = [data[i:i + ITEM] for i in range(0, len(data), ITEM)]
    comp = {}
    v2_launches = 0
    for level in TIER_LEVELS:
        bc = BatchCompressor(level=level, use_device=True, device="cuda")
        # this tier starts here
        dtab.LAUNCHES = asm.LAUNCHES = sl.LAUNCHES = em.LAUNCHES = 0
        mv2.LAUNCHES = 0
        walls = []
        with counting_phases() as phases:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = bc.compress_batch(items)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        launches = (dtab.LAUNCHES, asm.LAUNCHES, sl.LAUNCHES, em.LAUNCHES,
                    mv2.LAUNCHES)
        passes = phases["assemble"]
        v2_launches += mv2.LAUNCHES
        assert (passes > 0) == (level >= 1), (level, passes)
        assert launches == (passes if level >= 4 else 0, passes, passes,
                            passes, passes), (level, launches, passes)
        for i, (it_, c) in enumerate(zip(items, out)):
            assert zlib.decompress(c, -15) == it_, f"L{level} item {i}"
        t0 = time.perf_counter()
        cpu = BatchCompressor(level=level, use_device=True, device="cpu") \
            .compress_batch(items[:N_CPU_ITEMS])
        cpu_s = time.perf_counter() - t0
        assert cpu == out[:N_CPU_ITEMS], f"L{level}: card bytes != CPU bytes"
        log(f"compress L{level}: {len(items)} items ({len(data)} bytes) "
            f"round-trip through zlib; ratio "
            f"{len(data) / sum(map(len, out)):.4f}; wall {walls[0]:.3f} s, "
            f"again {walls[1]:.3f} s; the first {N_CPU_ITEMS} items on the "
            f"CPU equal ({cpu_s:.2f} s); dyn_tables launches {launches[0]}, "
            f"assembly launches {launches[1]}, select launches "
            f"{launches[2]}, emit launches {launches[3]}, match_v2 launches "
            f"{launches[4]}, device passes {passes} (two runs)")
        comp[level] = out
    return items, comp, v2_launches


def phase_decode_tiers(data: bytes, items, comp, tier_slices):
    """The two-pass decoder on the L1 and L4 items and the level-0
    slices: byte-exact, host fallbacks only "in_cap" of streams over
    the 1 MiB input cap, pass 1 launched on each set."""
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.batch import MAX_STREAM
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    slices = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    sets = (("L1 items", comp[1], items, ITEM),
            ("L4 items", comp[4], items, ITEM),
            ("L0 slices", tier_slices[0], slices, SLICE))
    for name, streams, originals, cap in sets:
        over = sum(len(z) > MAX_STREAM for z in streams)
        bd = BatchDecompressor(use_device=True, resolve="device",
                               device="cuda")
        it.LAUNCHES = rs.LAUNCHES = 0       # this path starts here
        counts = route_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bd.decompress_batch(streams, [cap] * len(streams))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = route_counts(counts)
        bad = [i for i, (g, w) in enumerate(zip(got, originals)) if g != w]
        assert not bad, f"decompress {name}: items {bad[:10]} not byte-exact"
        assert dict(bd.fallbacks) == ({"in_cap": over} if over else {}), \
            f"decompress {name}: fallbacks {dict(bd.fallbacks)}, {over} over"
        assert it.LAUNCHES > 0, f"decompress {name}: pass 1 never launched"
        assert rs.LAUNCHES > 0, f"decompress {name}: resolve never launched"
        log(f"decompress {name}: {len(streams)} streams "
            f"({sum(map(len, streams))} bytes), {sum(map(len, originals))} "
            f"bytes byte-exact; host fallbacks {dict(bd.fallbacks)} ({over} "
            f"streams over {MAX_STREAM} B); pass-1 launches {it.LAUNCHES}, "
            f"resolve launches {rs.LAUNCHES}; segment route {counts}; wall "
            f"{dt:.3f} s")


def phase_small_tiers(data: bytes, tier_slices):
    """Batches of 1 and 7 L1 and L4 slices within inflate_v2's input cap
    through BatchDecompressor(use_device=True): byte-exact, no host
    fallback, inflate_v2 launched and pass 1 not."""
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    for level in (1, 4):
        fit = [(z, data[i * SLICE:(i + 1) * SLICE])
               for i, z in enumerate(tier_slices[level])
               if len(z) <= v2.IN_CAP][:max(N_SMALL)]
        for n in N_SMALL:
            bd = BatchDecompressor(use_device=True, device="cuda")
            v2.LAUNCHES = it.LAUNCHES = 0     # this path starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = bd.decompress_batch([z for z, _ in fit[:n]], [SLICE] * n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            assert got == [c for _, c in fit[:n]], f"L{level} x{n}: bytes"
            assert not bd.fallbacks, f"L{level} x{n}: {dict(bd.fallbacks)}"
            assert v2.LAUNCHES > 0 and it.LAUNCHES == 0, \
                (v2.LAUNCHES, it.LAUNCHES)
            log(f"small batch L{level}: {n} slices of 64 KiB byte-exact, "
                f"host fallbacks {{}}; inflate_v2 launches {v2.LAUNCHES}, "
                f"pass 1 {it.LAUNCHES}; wall {dt * 1e3:.1f} ms")


def phase_static_tier(data: bytes, tier_slices):
    """inflate_device_static on the first N_STATIC L1 slices within its
    input cap, byte-exact, its kernel launched; the same rows held to
    the plain version word for word."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_device_static
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st

    fit = [(z, data[i * SLICE:(i + 1) * SLICE])
           for i, z in enumerate(tier_slices[1])
           if len(z) <= st.IN_CAP][:N_STATIC]
    assert len(fit) == N_STATIC, f"only {len(fit)} L1 slices fit"
    streams, originals = [z for z, _ in fit], [c for _, c in fit]
    st.LAUNCHES = 0                           # this path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = inflate_device_static(streams, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert got == originals, "inflate_device_static on L1: not byte-exact"
    assert st.LAUNCHES > 0, "the L1 static path never launched its kernel"
    log(f"inflate_device_static: {N_STATIC} L1 slices of 64 KiB "
        f"({sum(map(len, streams))} bytes in) byte-exact; launches "
        f"{st.LAUNCHES}; wall {dt * 1e3:.1f} ms")
    err, ms, plain_ms, _ = stream_kernel_vs_plain(
        st, "inflate_static", fit, "inflate_static on L1 slices")
    log(f"  inflate_static vs plain on those rows: equal, max abs err {err}; "
        f"kernel {ms:.3f} ms per launch (CUDA events, {KERNEL_REPS} "
        f"launches); plain version {plain_ms:.1f} ms (host clock, one run)")
    return err


def phase_checksums(data: bytes):
    """crc32_device and adler32_device of the corpus, crc32_blocks and
    adler32_blocks of its 64 KiB blocks, through the checksum kernel:
    equal to zlib, timed (each device call's first wall is the process's
    first call of the kernel path)."""
    import numpy as np
    import torch
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    for name, fn, ref in (("crc32_device", ck.crc32_device, zlib.crc32),
                          ("adler32_device", ck.adler32_device,
                           zlib.adler32)):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = fn(data, device="cuda")
            walls.append(time.perf_counter() - t0)
        assert got == ref(data), f"{name} != zlib"
        log(f"{name} of the corpus ({len(data)} bytes): equal to zlib; "
            f"wall {walls[0] * 1e3:.1f} ms (the process's first call of "
            f"the checksum kernel), again {walls[1] * 1e3:.1f} ms (host "
            f"clock, bytes to the card included)")
    nblk = -(-len(data) // SLICE)
    arr = np.zeros(nblk * SLICE, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    rows = torch.from_numpy(arr.reshape(nblk, SLICE)).cuda()
    lengths = torch.tensor([min(SLICE, len(data) - i * SLICE)
                            for i in range(nblk)], device="cuda")
    blocks = [data[i * SLICE:(i + 1) * SLICE] for i in range(nblk)]
    for name, fn, ref in (("crc32_blocks", ck.crc32_blocks, zlib.crc32),
                          ("adler32_blocks", ck.adler32_blocks,
                           zlib.adler32)):
        got = fn(rows, lengths).cpu().tolist()
        assert got == [ref(b) for b in blocks], f"{name} != zlib"
        ms = time_cuda(lambda: fn(rows, lengths), KERNEL_REPS)
        log(f"{name} of the corpus's {nblk} blocks of 64 KiB: equal to zlib; "
            f"{ms:.3f} ms per call (CUDA events, {KERNEL_REPS} calls)")


def tier_slices(data: bytes) -> dict:
    """The first N_SLICES 64 KiB slices compressed on the card at levels
    0, 1 and 4, one stream each: {level: streams}."""
    from libdeflate_rsx_tpu_torch import BatchCompressor

    slices = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    return {level: BatchCompressor(level=level, use_device=True,
                                   device="cuda").compress_batch(slices)
            for level in TIER_LEVELS}


def one_pass_peak(fn):
    """(fn(), its peak device memory in bytes above what was held before
    it), with the peak counter reset first."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - held


def phase_budget_coefficients(data: bytes, items, comp, card: str):
    """Phase 18a: the one-pass peak per byte of each pass kind's units
    (budget.py: block rows for the compress tiers, max(out_cap, input)
    per stream for the two-pass decode) on the corpus, one pass each;
    every one must stay within budget.PEAK_PER_BYTE. Returns the L6
    outputs of the items, one item at a time, and the measured
    coefficients."""
    from libdeflate_rsx_tpu_torch import BatchDecompressor, budget
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import BLOCK_PAD

    rows = sum(-(-len(d) // SLICE) for d in items)
    runs = (
        ("static", lambda: gs.deflate_device_static(data, device="cuda"),
         -(-len(data) // SLICE) * (SLICE + BLOCK_PAD)),
        ("dynamic", lambda: gd.deflate_device_dynamic_many(items,
                                                           device="cuda"),
         rows * (SLICE + BLOCK_PAD)),
        ("l6", lambda: gd.deflate_device_l6_many(items, device="cuda"),
         rows * (gd.HIST + SLICE + BLOCK_PAD)),
        ("decode", lambda: BatchDecompressor(
            use_device=True, resolve="device", device="cuda")
            .decompress_batch(comp, [ITEM] * len(comp)),
         len(comp) * ITEM))
    coefs = {}
    for kind, fn, size in runs:
        budget.PASSES.clear()
        out, peak = one_pass_peak(fn)
        assert budget.PASSES[kind] == 1, (kind, dict(budget.PASSES))
        if kind == "l6":
            assert out == comp, "L6 _many != the main path's L6 bytes"
        if kind == "decode":
            assert out == items, "decode of the L6 items not byte-exact"
        coef = coefs[kind] = peak / size
        per_input = peak / (len(data) if kind != "decode"
                            else len(comp) * ITEM)
        log(f"budget {kind}: one pass over the corpus peaks at "
            f"{peak / 2**20:.1f} MiB = {coef:.2f} B per unit byte "
            f"({size} unit bytes; {per_input:.2f} B per "
            f"{'input' if kind != 'decode' else 'out_cap'} byte); "
            f"PEAK_PER_BYTE {budget.PEAK_PER_BYTE[kind]} [{card}]")
        assert coef <= budget.PEAK_PER_BYTE[kind], \
            f"budget {kind}: measured {coef:.2f} B per byte > coefficient"
    singles = [gd.deflate_device_l6(d, device="cuda") for d in items]
    assert singles == comp, "L6 per item != L6 _many"
    return singles, coefs


def phase_budget_over(items, singles, coefs, card: str):
    """Phase 18b: one L6 compress_batch and one device-resolve decode of
    the corpus items repeated, each of which would need at least
    BUDGET_OVER x the card's memory in one pass at the peaks measured
    in phase 18a (`coefs`): 2 or more passes, every item's bytes equal
    to its single compress, every decode byte-exact, no host
    fallback."""
    import torch
    from libdeflate_rsx_tpu_torch import (BatchCompressor,
                                          BatchDecompressor, budget)
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import BLOCK_PAD

    total = torch.cuda.get_device_properties(0).total_memory
    width = gd.HIST + SLICE + BLOCK_PAD
    rows = [width] * sum(-(-len(d) // SLICE) for d in items)
    reps = math.ceil(BUDGET_OVER * total / (coefs["l6"] * sum(rows)))
    big = items * reps
    budget.PASSES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = BatchCompressor(level=6, use_device=True,
                          device="cuda").compress_batch(big)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    est = budget.estimate("l6", rows * reps)
    passes = budget.PASSES["l6"]
    assert passes >= 2, f"L6 over the budget in {passes} pass"
    bad = [i for i, o in enumerate(out) if o != singles[i % len(items)]]
    assert not bad, f"L6 items {bad[:10]} != their single compress"
    need = coefs["l6"] * sum(rows) * reps
    log(f"budget L6: {len(big)} items ({sum(map(len, big))} bytes, the "
        f"corpus items {reps} times), one pass would need "
        f"{need / 2**30:.1f} GiB = {need / total:.2f} x the card's "
        f"{total / 2**30:.1f} GiB (estimate {est / 2**30:.1f} GiB): "
        f"{passes} passes, every item equal to its single compress; "
        f"wall {dt:.3f} s [{card}]")
    del out, big

    unit = it.cap_bucket([ITEM])
    reps = math.ceil(BUDGET_OVER * total
                     / (coefs["decode"] * unit * len(singles)))
    streams = singles * reps
    bd = BatchDecompressor(use_device=True, resolve="device", device="cuda")
    budget.PASSES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bd.decompress_batch(streams, [ITEM] * len(streams))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    passes = budget.PASSES["decode"]
    assert passes >= 2, f"decode over the budget in {passes} pass"
    bad = [i for i, g in enumerate(got) if g != items[i % len(items)]]
    assert not bad, f"decode: streams {bad[:10]} not byte-exact"
    assert not bd.fallbacks, f"decode: host fallbacks {dict(bd.fallbacks)}"
    need = coefs["decode"] * unit * len(streams)
    est = budget.estimate("decode", [unit] * len(streams))
    log(f"budget decode: {len(streams)} streams (the L6 items {reps} "
        f"times, {sum(map(len, got))} bytes out), resolve on the card, "
        f"one pass would need {need / 2**30:.1f} GiB = "
        f"{need / total:.2f} x the card's memory (estimate "
        f"{est / 2**30:.1f} GiB): {passes} passes, byte-exact, host "
        f"fallbacks {{}}; wall {dt:.3f} s [{card}]")
    del got, streams
    torch.cuda.empty_cache()


def sharded_compress(data: bytes, items, device,
                     launches=None) -> tuple[dict, dict]:
    """ShardedCompressor on the corpus: the static tier in the three
    formats, the dynamic tier in deflate and the static compress_batch
    over the items; every output through zlib. Returns ({name: bytes},
    {name: (wall s, collective s)}); fills `launches` with {name:
    checksum kernel launches} when given."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from libdeflate_rsx_tpu_torch.parallel import ShardedCompressor

    static = ShardedCompressor(device=device)
    dynamic = ShardedCompressor(tier="dynamic", device=device)
    runs = {f"static {f}": (lambda f=f: static.compress(data, f), static)
            for f in ("deflate", "zlib", "gzip")}
    runs["dynamic deflate"] = (lambda: dynamic.compress(data), dynamic)
    runs["static batch"] = (lambda: static.compress_batch(items), static)
    outs, times = {}, {}
    for name, (fn, sc) in runs.items():
        before = ck.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0, sc.collective_seconds)
        if launches is not None:
            launches[name] = ck.LAUNCHES - before
    for f in ("deflate", "zlib", "gzip"):
        got = {"deflate": lambda b: zlib.decompress(b, -15),
               "zlib": zlib.decompress,
               "gzip": gzip.decompress}[f](outs[f"static {f}"])
        assert got == data, f"sharded static {f}: round trip"
    assert zlib.decompress(outs["dynamic deflate"], -15) == data, "dynamic"
    for i, (d, o) in enumerate(zip(items, outs["static batch"])):
        assert zlib.decompress(o, -15) == d, f"sharded batch item {i}"
    return outs, times


def sharded_decode(streams, chunks, device) -> dict:
    """ShardedDecompressor on the zlib-6 slices with host and device
    resolve: every stream within the 64 KiB input cap byte-exact, the
    others None (the JAX package's contract). Returns {resolve: (wall s,
    collective s, pass-1 launches)}."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.parallel import ShardedDecompressor

    want = [c if len(z) <= it.IN_CAP else None
            for z, c in zip(streams, chunks)]
    out = {}
    for resolve in ("host", "device"):
        dec = ShardedDecompressor(resolve=resolve, device=device)
        launches = it.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dec.decompress_batch(streams)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        assert not bad, f"sharded decode {resolve}: streams {bad[:10]}"
        assert it.LAUNCHES > launches, f"sharded decode {resolve}: no pass 1"
        out[resolve] = (dt, dec.collective_seconds, it.LAUNCHES - launches)
    return out


def digests(outs: dict) -> dict:
    import hashlib
    return {k: hashlib.sha256(b"".join(v) if isinstance(v, list) else v)
            .hexdigest() for k, v in outs.items()}


def phase_sharded_nccl(data: bytes, items, card: str) -> tuple[dict, int]:
    """Phase 19: ShardedCompressor at NCCL world size 1 on the corpus;
    the static payload equal to deflate_device_static, the dynamic one
    to deflate_device_dynamic, the batch to the items' static encodes;
    the static zlib and gzip compress each launch the checksum kernel
    twice a pass (crc32_blocks and adler32_blocks), the other runs not
    at all. Returns the outputs' digests and the checksum kernel's
    launches on the static zlib and gzip compress."""
    from libdeflate_rsx_tpu_torch import budget
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import BLOCK_PAD
    from libdeflate_rsx_tpu_torch.parallel import multihost

    multihost.initialize(multihost.file_rendezvous(tempfile.mkdtemp()), 1,
                         0, backend="nccl")
    launches = {}
    outs, times = sharded_compress(data, items, "cuda", launches)
    nblk = -(-len(data) // SLICE)
    passes = len(budget.passes("static", [SLICE + BLOCK_PAD] * nblk, "cuda"))
    framed = launches["static zlib"] + launches["static gzip"]
    assert framed == 2 * passes * 2 and launches["static zlib"] == \
        launches["static gzip"] and framed == sum(launches.values()), \
        f"checksum kernel launches {launches} in {passes} passes"
    log(f"checksum kernel launches on the sharded static zlib and gzip "
        f"compress: {framed} ({passes} pass(es) each, crc32_blocks and "
        f"adler32_blocks a pass; none in the other runs)")
    assert outs["static deflate"] == gs.deflate_device_static(
        data, device="cuda"), "sharded static != deflate_device_static"
    assert outs["dynamic deflate"] == gd.deflate_device_dynamic(
        data, device="cuda"), "sharded dynamic != deflate_device_dynamic"
    assert outs["static batch"] == [gs.deflate_device_static(
        d, device="cuda") for d in items], "sharded batch != per item"
    for name, (wall, coll) in times.items():
        log(f"sharded NCCL x1 {name}: {sum(map(len, items))} bytes, "
            f"equal to the single-card tier, round-trips through zlib; "
            f"wall {wall:.3f} s, collectives {coll * 1e3:.2f} ms [{card}]")
    return digests(outs), framed


def phase_sharded_decode_nccl(slices, chunks, card: str) -> None:
    """Phase 21, world size 1: ShardedDecompressor over NCCL on the 256
    zlib-6 slices, host and device resolve."""
    import torch.distributed as dist
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    for resolve, (wall, coll, n) in sharded_decode(slices, chunks,
                                                   "cuda").items():
        log(f"sharded decode NCCL x1, resolve {resolve}: {len(slices)} "
            f"zlib-6 slices, {sum(len(z) <= it.IN_CAP for z in slices)} "
            f"within the 64 KiB input cap byte-exact, the rest None; "
            f"pass-1 launches {n}; wall {wall:.3f} s, collectives "
            f"{coll * 1e3:.2f} ms [{card}]")
    dist.destroy_process_group()


def short_slices(data: bytes):
    """(zlib-6 streams, their bytes) of the first CHECK_SLICE bytes of
    each of the N_SLICES slices: phase 20's shared-card decode set. Each
    takes a whole 64 KiB out_cap row on the card, as a full slice does,
    but brings a quarter of its bytes to the host, where both ranks hold
    every decoded stream."""
    chunks = [data[i * SLICE:i * SLICE + CHECK_SLICE]
              for i in range(N_SLICES)]
    return [raw_z(c) for c in chunks], chunks


def shared_card_decode(streams, chunks, reps: int) -> dict:
    """Phase 20's decode over the memory the ranks share: the short
    slices `reps` times through ShardedDecompressor, resolve on the
    card; every stream within the input cap byte-exact, 2 or more
    passes on this rank. Returns its passes, budget and wall."""
    import torch
    from libdeflate_rsx_tpu_torch import budget
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.parallel import ShardedDecompressor

    want = [c if len(z) <= it.IN_CAP else None
            for z, c in zip(streams, chunks)]
    dec = ShardedDecompressor(resolve="device", device="cuda")
    limit = budget.limit("cuda")
    budget.PASSES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dec.decompress_batch(streams * reps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [i for i, g in enumerate(got) if g != want[i % len(want)]]
    assert not bad, f"shared-card decode: streams {bad[:10]}"
    passes = budget.PASSES["decode"]
    assert passes >= 2, f"shared-card decode in {passes} pass"
    return {"streams": len(got), "passes": passes, "limit": limit,
            "sharers": budget.SHARERS, "wall": dt,
            "collective": dec.collective_seconds}


def gloo_rank(rank: int, n: int, init: str, out: str, reps: int) -> None:
    """One of phase 20's ranks: gloo, its encoders on the one card. The
    sharded compress of phase 19, compress_global in gzip, the sharded
    decode of phase 21 and the decode over the shared card's memory;
    writes digests and times to `out`."""
    import torch.distributed as dist
    from libdeflate_rsx_tpu_torch.parallel import multihost

    multihost.initialize(init, n, rank, backend="gloo",
                         timeout=datetime.timedelta(seconds=RENDEZVOUS))
    data = corpus()
    items = [data[i:i + ITEM] for i in range(0, len(data), ITEM)]
    outs, times = sharded_compress(data, items, "cuda")
    t0 = time.perf_counter()
    framed = multihost.compress_global(data, "gzip", device="cuda")
    t_global = time.perf_counter() - t0
    assert gzip.decompress(framed) == data, "compress_global gzip"
    chunks = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    slices = [raw_z(c) for c in chunks]
    dec = sharded_decode(slices, chunks, "cuda")
    del slices, chunks
    from libdeflate_rsx_tpu_torch import budget
    assert budget.SHARERS == n, f"ranks on the card: {budget.SHARERS}"
    shared = shared_card_decode(*short_slices(data), reps)
    with open(out, "w") as f:
        json.dump({"digests": digests(outs), "times": times,
                   "global_s": t_global, "decode": dec,
                   "shared": shared}, f)
    dist.destroy_process_group()


def phase_sharded_gloo(expect: dict, data: bytes, slices, card: str) -> None:
    """Phase 20 (and phase 21's 2-rank half): N_RANKS gloo ranks on the
    one card, child processes with a timeout; each rank's bytes must
    equal phase 19's. The one-pass peak per out_cap byte of the slices'
    decode (resolve on the card, 64 KiB out_cap) must stay within the
    budget's coefficient. The shared-card decode repeats the short
    slices (`short_slices`) until the ranks would need BUDGET_OVER x the
    card's memory in one pass each, at the one-pass peak per out_cap
    byte of their decode, measured here first."""
    import torch
    from libdeflate_rsx_tpu_torch import budget
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    total = torch.cuda.get_device_properties(0).total_memory
    budget.PASSES.clear()
    _, peak = one_pass_peak(lambda: it.inflate_device_fused(
        slices, it.OUT_CAP, it.IN_CAP, "cuda"))
    assert budget.PASSES["decode"] == 1, dict(budget.PASSES)
    coef = peak / (it.OUT_CAP * len(slices))
    log(f"budget decode at the 64 KiB out_cap: one pass over the "
        f"{len(slices)} slices peaks at {peak / 2**20:.1f} MiB = "
        f"{coef:.2f} B per out_cap byte; PEAK_PER_BYTE "
        f"{budget.PEAK_PER_BYTE['decode']} [{card}]")
    assert coef <= budget.PEAK_PER_BYTE["decode"], \
        f"budget decode: measured {coef:.2f} B per byte > coefficient"
    short, _ = short_slices(data)
    budget.PASSES.clear()
    _, peak = one_pass_peak(lambda: it.inflate_device_fused(
        short, it.OUT_CAP, it.IN_CAP, "cuda"))
    assert budget.PASSES["decode"] == 1, dict(budget.PASSES)
    coef = peak / (it.OUT_CAP * len(short))
    log(f"budget decode at the 64 KiB out_cap: one pass over the "
        f"{len(short)} short slices ({CHECK_SLICE} B each) peaks at "
        f"{peak / 2**20:.1f} MiB = {coef:.2f} B per out_cap byte [{card}]")
    torch.cuda.empty_cache()
    reps = math.ceil(BUDGET_OVER * total / (coef * it.OUT_CAP * N_SLICES))
    outdir = os.path.join(ROOT, "build", "smoke_ranks")
    os.makedirs(outdir, exist_ok=True)
    outs = [os.path.join(outdir, f"rank{r}.json") for r in range(N_RANKS)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    from libdeflate_rsx_tpu_torch.parallel.entry import run_ranks
    t0 = time.perf_counter()
    run_ranks(lambda r, init: [
        sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
        str(N_RANKS), init, outs[r], str(reps)], N_RANKS, RANK_TIMEOUT)
    dt = time.perf_counter() - t0
    for r, o in enumerate(outs):
        res = json.load(open(o))
        assert res["digests"] == expect, f"gloo rank {r}: bytes != NCCL x1"
        for name, (wall, coll) in res["times"].items():
            log(f"sharded gloo x{N_RANKS} rank {r} {name}: equal to NCCL x1; "
                f"wall {wall:.3f} s, collectives {coll * 1e3:.2f} ms "
                f"[{card}]")
        log(f"sharded gloo x{N_RANKS} rank {r} compress_global gzip: "
            f"gunzips to the corpus; wall {res['global_s']:.3f} s [{card}]")
        for resolve, (wall, coll, n) in res["decode"].items():
            log(f"sharded decode gloo x{N_RANKS} rank {r}, resolve "
                f"{resolve}: byte-exact within the input cap; pass-1 "
                f"launches {n}; wall {wall:.3f} s, collectives "
                f"{coll * 1e3:.2f} ms [{card}]")
        sh = res["shared"]
        log(f"shared-card decode gloo x{N_RANKS} rank {r}: "
            f"{sh['streams']} streams (the short slices {reps} times; "
            f"{sh['sharers']} ranks on the card, pass budget "
            f"{sh['limit'] / 2**30:.1f} GiB), in {sh['passes']} passes, "
            f"byte-exact within the input cap; wall {sh['wall']:.3f} s, "
            f"collectives {sh['collective'] * 1e3:.2f} ms [{card}]")
    need = coef * it.OUT_CAP * N_SLICES * reps
    log(f"shared-card decode: the {N_RANKS} ranks would need "
        f"{need / 2**30:.1f} GiB = {need / total:.2f} x the card's "
        f"{total / 2**30:.1f} GiB in one pass each [{card}]")
    log(f"phase 20: {N_RANKS} gloo ranks on the one card in {dt:.1f} s "
        f"(process start included)")


def device_pass(items, level: int) -> dict:
    """One compress pass over every block of the items at level 1, 4 or
    6, through the encode flows' own helpers up to the assembly: the
    items' first rows (metas), the assembly's inputs and, at levels 4
    and 6, the table step's inputs (histograms and finals)."""
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs

    metas, arr, valid, hist, finals = gd.split_many(items, SLICE, level >= 6)
    if level < 4:
        return {"metas": metas,
                "inputs": gs.static_pass(arr, valid, finals, SLICE, "cuda")}
    inputs, (llh, ofh) = gd.dynamic_pass(arr, valid, finals, SLICE, "cuda",
                                         hist)
    return {"metas": metas, "inputs": inputs,
            "hist": (llh, ofh, inputs.finals)}


def tie_histograms(n: int, seed: int):
    """(ll (n, 288), of (n, 30)) uint16 tensors on the card: counts from
    {0, 1} and {0, 1, 2}, geometric, sparse, and edge cases (an empty
    block, one literal, all 288 symbols, counts saturated at 65,535,
    geometric counts past the 14-bit limit, an all-zero offset row)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ll = np.zeros((n, 288), np.int64)
    of = np.zeros((n, 30), np.int64)
    for k in range(n):
        kind = k % 4
        if kind == 0:
            ll[k, :286] = rng.integers(0, 2, 286)
            of[k] = rng.integers(0, 2, 30)
        elif kind == 1:
            ll[k, :286] = rng.integers(0, 3, 286)
            of[k] = rng.integers(0, 3, 30)
        elif kind == 2:
            ll[k, :286] = rng.geometric(0.01, 286) * (rng.random(286) < 0.6)
            of[k] = rng.geometric(0.1, 30) * (rng.random(30) < 0.5)
        else:
            used = rng.choice(286, rng.integers(1, 8), replace=False)
            ll[k, used] = rng.integers(1, 4, len(used))
    fib = [1, 1]
    while len(fib) < 288:
        fib.append(min(fib[-1] + fib[-2], 65535))
    ll[0], of[0] = 0, 0
    ll[1], of[1] = 0, 0
    ll[1, 65] = 9
    ll[2], of[2] = 1, 1
    ll[3], of[3] = 65535, 65535
    ll[4], of[4] = fib, fib[:30]
    ll[5], of[5] = fib[::-1], 0
    return tuple(torch.from_numpy(np.minimum(x, 65535).astype(np.int32))
                 .to(torch.uint16).cuda() for x in (ll, of))


def tables_vs_plain(ll, of, finals, label: str):
    """The table kernel and its plain version on the same histograms:
    all four outputs equal. Returns the max abs err."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dtab

    got = dtab.build_tables(ll, of, finals)
    want = dtab.build_tables_plain(ll, of, finals)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, want)), \
        f"dyn_tables {label}: kernel != plain (max abs err {err})"
    return err


def phase_tables_kernel(items, card: str, l6: dict):
    """Phase 22: the table kernel against the Python builder on the
    corpus's L6 and L4 histograms, tie-heavy and edge histograms; then
    its record, timed on the L6 histograms. Returns the record."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dtab

    llh, ofh, finals = l6["hist"]
    errs = [tables_vs_plain(llh, ofh, finals, "L6 blocks")]
    l4 = device_pass(items, 4)
    errs.append(tables_vs_plain(*l4["hist"], "L4 blocks"))
    del l4
    ll, of = tie_histograms(N_TIE_HISTS, seed=22)
    fin = torch.arange(N_TIE_HISTS, device="cuda") % 3 == 0
    errs.append(tables_vs_plain(ll, of, fin, "tie-heavy and edge"))
    ms = time_cuda(lambda: dtab.build_tables(llh, ofh, finals), KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dtab.build_tables_plain(llh, ofh, finals)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    b = llh.shape[0]
    nbytes = b * ((288 + 30) * 2 + 1) + b * ((288 + 30) * 4 + dtab.HDR_CAP + 4)
    log(f"dyn_tables vs plain: equal on the {b} L6 and {b} L4 blocks' "
        f"histograms and {N_TIE_HISTS} tie-heavy and edge histograms, max "
        f"abs err {max(errs)}; kernel {ms:.3f} ms per launch on the {b} L6 "
        f"histograms (CUDA events, {KERNEL_REPS} launches); plain version "
        f"{plain_ms:.1f} ms (host clock, one run) [{card}]")
    return record("dyn_tables", "native/codec.c dyn_tables_c (as "
                  "_build_tables_py)", max(errs), ms, plain_ms, nbytes)


def assembly_vs_plain(inp, label: str):
    """The assembly kernel in its three modes (assemble; place_rows, then
    join_rows on its output) and its plain versions on one pass's rows
    (`inp`, assemble's inputs): streams, byte counts and joined bytes
    equal. Returns (max abs err, joined bytes, sizes, nbytes)."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    place, join, cap = inp[:8], inp[8:10] + (inp.finals,), inp.out_cap
    joined_a, sizes_a = asm.assemble(*inp)
    out_k, nb_k = asm.place_rows(*place, cap)
    out_p, nb_p = asm.place_rows_plain(*place, cap)
    joined_k, sizes_k = asm.join_rows(out_k, nb_k, *join)
    joined_p, sizes_p = asm.join_rows_plain(out_p, nb_p, *join)
    torch.cuda.synchronize()

    def diff(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    err = max(diff(out_k[:, :cap], out_p), diff(nb_k, nb_p),
              *(diff(j, joined_p) if j.numel() == joined_p.numel()
                else 1 << 30 for j in (joined_k, joined_a)))
    assert torch.equal(out_k[:, :cap], out_p) and torch.equal(nb_k, nb_p) \
        and (sizes_k == sizes_p).all() and torch.equal(joined_k, joined_p) \
        and (sizes_a == sizes_p).all() and torch.equal(joined_a, joined_p), \
        f"assembly {label}: kernel != plain (max abs err {err})"
    return err, joined_a, sizes_a, nb_k


def assembly_bytes(inp, sizes, stored) -> int:
    """Bytes the assembly must move, each once: the row bytes that hold
    bits (each row's extent), the header bytes in use, the rows' offsets
    and bit starts, each block's end bit, header bit count, EOB code,
    final flag and raw length, the raw bytes of the stored blocks, and
    the joined streams and their sizes written."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    b0, end = inp.row_bit0, inp.end_bits
    nxt = torch.cat([b0[:, 1:], end[:, None]], dim=1)
    ext = torch.where(nxt > b0, asm.row_extents(b0, end, inp.rows.shape[2]),
                      0)
    hdr = (inp.hdr_bits.long() + 7) >> 3
    b = b0.shape[0]
    raw = int(inp.raw_len.long().cpu().numpy()[stored].sum())
    return (int(ext.sum()) + int(hdr.sum()) + 16 * b0.numel()
            + b * (8 + 4 + 4 + 1 + 8) + raw + int(sizes.sum()) + 8 * b)


def phase_assembly_kernel(items, comp, card: str, l6: dict):
    """Phase 23: the assembly kernel against its plain versions on the
    L1, L4 and L6 rows of the corpus items with a 64 KiB random item
    (stored), then the record on the L6 pass of the corpus items, whose
    joined streams must be the main path's bytes. Returns the record."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import assemble as asm

    rand = random.Random(23).randbytes(SLICE)
    errs = []
    for level in (1, 4, 6):
        inp = device_pass(items + [rand], level)["inputs"]
        err, _, sizes, nbytes = assembly_vs_plain(inp, f"L{level}")
        stored = int((sizes < nbytes.cpu().numpy()).sum())
        assert stored >= 1, f"L{level}: no stored block"
        errs.append(err)
        log(f"assembly vs plain L{level}: {inp.rows.shape[0]} blocks "
            f"(the corpus items and a 64 KiB random item), {stored} stored; "
            f"equal, max abs err {err}")
        del inp
        torch.cuda.empty_cache()
    inp = l6["inputs"]
    err, joined, sizes, nbytes = assembly_vs_plain(inp, "L6 corpus")
    errs.append(err)
    parts = asm.split_parts(joined, sizes)
    got = [b"".join(parts[a:a + n]) for a, n in l6["metas"]]
    assert got == comp, "the L6 pass's joined streams != phase 4's outputs"
    place, join, cap = inp[:8], inp[8:10] + (inp.finals,), inp.out_cap
    ms = time_cuda(lambda: asm.assemble_async(*inp), KERNEL_REPS)
    ms_place = time_cuda(lambda: asm.place_rows(*place, cap), KERNEL_REPS)
    ms_call = time_cuda(lambda: asm.assemble(*inp), KERNEL_REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asm.join_rows_plain(*asm.place_rows_plain(*place, cap), *join)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    stored = sizes < nbytes.cpu().numpy()
    nbytes_moved = assembly_bytes(inp, sizes, stored)
    log(f"assembly on the L6 pass of the corpus items "
        f"({inp.rows.shape[0]} blocks, {tuple(inp.rows.shape)} rows, "
        f"{int(stored.sum())} stored, shared-memory build buffer "
        f"{4 * -(-min(cap, asm.stored_cost(inp.raw.shape[1])) // 4)} B a "
        f"block of {asm.smem_limit(inp.rows.device)}): equal to phase 4's "
        f"outputs; assemble's one launch {ms:.3f} ms per pass (no host "
        f"sync), the whole `assemble` call with its host sync "
        f"{ms_call:.3f} ms, place_rows alone (its (B, pitch) buffer) "
        f"{ms_place:.3f} ms (CUDA events, {KERNEL_REPS} calls each); plain "
        f"versions {plain_ms:.1f} ms (host clock, one run, on the card) "
        f"[{card}]")
    return record("assemble_rows", "native/assemble.c assemble_rows",
                  max(errs), ms, plain_ms, nbytes_moved)


def resolve_vs_plain(tokens, out_cap: int, label: str, counts=None):
    """The resolve kernel and its plain version on the card on the same
    columns (and token counts): outlen and ok equal, and the bytes [0,
    outlen) of every ok row. Returns (max abs err, ok rows, rows)."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    out_k, len_k, ok_k = rs.resolve_batch(tokens, out_cap, counts)
    out_p, len_p, ok_p = rs.resolve_batch_plain(tokens, out_cap, counts)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape == (tokens.shape[0], out_cap), label
    assert torch.equal(len_k, len_p), f"{label}: outlen differs"
    assert torch.equal(ok_k, ok_p), f"{label}: ok differs"
    err = 0
    for i in ok_k.nonzero().flatten().tolist():
        n = int(len_k[i])
        if n:
            err = max(err, int((out_k[i, :n].int() - out_p[i, :n].int())
                               .abs().max()))
    assert err == 0, f"{label}: bytes differ, max abs err {err}"
    return err, int(ok_k.sum()), tokens.shape[0]


def pass1_columns(streams, out_cap: int):
    """Pass 1's tokens of the streams as the main path hands them to
    resolve (the strided view of its (B, out_cap) buffer, cut to the
    longest column), with its stats."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams(streams, it.in_cap_bucket(streams), "cuda")[:3]
    tok, st = it.pass1(*args, out_cap)
    stats = st.cpu().numpy()
    return tok[:, :max(1, int(stats[:, 3].max()))], stats


def kernel_times(fn, reps: int, tries: int = 3) -> dict:
    """{kernel name: device microseconds per call} of reps calls of fn
    under torch.profiler (a name without its namespace and arguments):
    the mean of the launches it recorded, times the launches a call
    (rounded, at least 1), so that launches the profiler drops, which
    happens at random on the card machine, do not lower it; profiled
    again, up to `tries` times, when a run records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    got = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and \
                    e.self_device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].split("::")[-1].split("<")[0] \
                    or e.key
                got[name] = got.get(name, 0.0) + \
                    e.self_device_time_total / e.count \
                    * max(1, round(e.count / reps))
        if got:
            break
    return got


def resolve_stages(tokens, out_cap: int, counts, reps: int) -> str:
    """Device microseconds of each kernel (and the scan state's clear) of
    one resolve call, the mean of reps calls (torch.profiler), as text."""
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    got = kernel_times(lambda: rs.resolve_batch(tokens, out_cap, counts),
                       reps)
    return ", ".join(f"{k} {v:.1f} us" for k, v in sorted(got.items())) \
        or "not recorded by the profiler"


def resolve_bytes(stats, outlen) -> int:
    """Bytes resolve must move: each real token read once (stats[:, 3]),
    each output byte up to outlen written once, outlen and ok."""
    return 4 * int(stats[:, 3].sum()) + int(outlen.sum()) \
        + 5 * stats.shape[0]


def phase_resolve_kernel(comp, slices, card: str):
    """Phase 24: the resolve kernel against its plain version on the
    card: pass 1's tokens of the 256 zlib-6 slices, the 17 L6 items and
    1 MiB of one byte at zlib-6, with and without pass 1's token counts;
    the hand-built columns of tests/test_torch_resolve.py and the edge
    columns (tests/_port_corpus.py resolve_cases: a 1 MiB dist-1 run and
    a 1 MiB chain of distance-4 matches, periodic chains at d 2..33, d
    32,768 across windows, matches before the start, sums at and past
    out_cap, NOP and kind-3 tokens anywhere, seeded random columns with
    both); T == 0 and B == 0. Then the record on the L6 items' tokens
    (the main path's decode, with its counts), with the 256 slices
    beside it, and each kernel's device time. Returns the record."""
    import numpy as np
    import torch
    from _port_corpus import resolve_cases
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    errs = []
    run = rs.LAUNCHES
    one = bytes([0x5A]) * ITEM
    sets = (("256 zlib-6 slices", slices, SLICE),
            (f"{len(comp)} L6 items", comp, ITEM),
            ("1 MiB of one byte at zlib-6", [raw_z(one)], ITEM))
    for label, streams, cap in sets:
        tok, stats = pass1_columns(streams, cap)
        counts = torch.from_numpy(stats[:, 3].copy()).cuda()
        for with_counts in (None, counts):
            err, n_ok, n = resolve_vs_plain(tok, cap, label, with_counts)
            errs.append(err)
        log(f"resolve vs plain on pass 1's tokens of the {label}: equal on "
            f"{n} rows ({n_ok} ok), {int(stats[:, 3].sum())} tokens, "
            f"with and without the token counts, max abs err {err}")
    for label, cols, cap in resolve_cases():
        tok = torch.from_numpy(np.stack(cols)).cuda()
        err, n_ok, n = resolve_vs_plain(tok, cap, label)
        errs.append(err)
        log(f"resolve vs plain, {label}: equal on {n} columns ({n_ok} ok) "
            f"of {tok.shape[1]} tokens at out_cap {cap}")
    for shape in ((3, 0), (0, 5)):
        tok = torch.zeros(shape, dtype=torch.int32, device="cuda")
        errs.append(resolve_vs_plain(tok, SLICE, f"shape {shape}")[0])
    out, outlen, ok = rs.resolve_batch(
        torch.zeros((3, 0), dtype=torch.int32, device="cuda"), SLICE)
    assert outlen.tolist() == [0, 0, 0] and bool(ok.all())
    log(f"resolve vs plain, T == 0 and B == 0: equal; kernel launches in "
        f"this phase {rs.LAUNCHES - run}")

    times = {}
    for label, streams, cap in sets[:2]:
        tok, stats = pass1_columns(streams, cap)
        counts = torch.from_numpy(stats[:, 3].copy()).cuda()
        ms = time_cuda(lambda: rs.resolve_batch(tok, cap, counts),
                       KERNEL_REPS)
        plain_ms = time_cuda(lambda: rs.resolve_batch_plain(tok, cap),
                             KERNEL_REPS)
        _, outlen, _ = rs.resolve_batch(tok, cap, counts)
        nbytes = resolve_bytes(stats, outlen.cpu().numpy())
        times[label] = (ms, plain_ms, nbytes)
        stages = resolve_stages(tok, cap, counts, KERNEL_REPS)
        log(f"resolve on the {label}: kernel {ms:.3f} ms, plain version "
            f"{plain_ms:.3f} ms on the card (CUDA events, {KERNEL_REPS} "
            f"calls each); {int(stats[:, 3].sum())} tokens (max "
            f"{int(stats[:, 3].max())} a column), {int(outlen.sum())} bytes "
            f"out; bound {nbytes / HBM_BYTES_PER_MS:.6f} ms ({nbytes} "
            f"bytes); device time per call (torch.profiler, {KERNEL_REPS} "
            f"calls): {stages} [{card}]")
    ms, plain_ms, nbytes = times[sets[1][0]]
    return record("resolve", "ops/resolve.py:47", max(errs), ms, plain_ms,
                  nbytes)


def l6_windows_of(datas, block: int):
    """The L6 pass's match-finder inputs for these items, as the encode
    flow builds them (history prefixes, first and short last blocks), on
    the card: (rows, valid, hist_start, s)."""
    import torch
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd

    _, arr, valid, hist, _ = gd.split_many(datas, block, True)
    return (*(torch.from_numpy(x).cuda() for x in (arr, valid, hist)),
            gd.HIST + block)


def match_vs_plain(rows, valid, hist, s, label: str) -> int:
    """The match kernel and its plain version on the card on the same
    windows: ml and dist equal. Returns the max abs err."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import \
        find_matches_l6_plain

    got = ml6.find_matches_l6(rows, valid, hist, s)
    want = find_matches_l6_plain(rows, valid, hist, s)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(g.dtype == torch.int64 and torch.equal(g, w)
               for g, w in zip(got, want)), \
        f"match_l6 {label}: kernel != plain (max abs err {err})"
    return err


def phase_match_kernel(items, card: str):
    """Phase 25: the match kernel against its plain version on the card,
    on the L6 pass's windows of the corpus items, zeros and random
    windows of that width, and the trap windows of the CPU tests; then
    its record, timed on the corpus windows. Returns the record."""
    import numpy as np
    import torch
    from _port_corpus import l6_windows
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops.encode_dynamic import \
        find_matches_l6_plain

    rows, valid, hist, s = l6_windows_of(items, SLICE)
    errs = [match_vs_plain(rows, valid, hist, s, "the corpus windows")]
    rng = np.random.default_rng(25)
    edge = [bytes(2 * SLICE), rng.integers(0, 256, 2 * SLICE - 999,
                                           dtype=np.uint8).tobytes()]
    errs.append(match_vs_plain(*l6_windows_of(edge, SLICE),
                               "zeros and random windows"))
    labels, t_rows, t_valid, t_hist, t_s = l6_windows()
    errs.append(match_vs_plain(*(torch.from_numpy(x).cuda()
                                 for x in (t_rows, t_valid, t_hist)), t_s,
                               "the trap windows"))
    log(f"match_l6 vs plain: equal on the {rows.shape[0]} corpus windows "
        f"(s = {s}), 2 zeros and 2 random windows of that width and "
        f"{len(labels)} trap windows (s = {t_s}: {', '.join(labels)}), max "
        f"abs err {max(errs)}")
    ms = time_cuda(lambda: ml6.find_matches_l6(rows, valid, hist, s),
                   KERNEL_REPS)
    plain_ms = time_cuda(
        lambda: find_matches_l6_plain(rows, valid, hist, s), KERNEL_REPS)
    b = rows.shape[0]
    nbytes = rows.numel() + 8 * b + 2 * 8 * b * s
    size, smem, clusters = ml6.launch_shape(s)
    log(f"match_l6 on the {b} corpus windows: kernel {ms:.3f} ms, plain "
        f"version {plain_ms:.3f} ms on the card (CUDA events, "
        f"{KERNEL_REPS} calls each); clusters of {size} blocks ({smem} B "
        f"of shared memory each), {clusters} resident, "
        f"{-(-b // clusters)} rounds [{card}]")
    return record("match_l6", "ops/encode_dynamic.py:194", max(errs), ms,
                  plain_ms, nbytes)


def select_vs_plain(ml, dist, valid, data, l6: bool, label: str) -> int:
    """The select kernel and its plain version on the card on the same
    inputs: every output equal. Returns the max abs err."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import select as sl

    got = sl.select(ml, dist, valid, data, l6=l6)
    want = sl.select_plain(ml, dist, valid, data, l6=l6)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want)), \
        f"select {label}: kernel != plain (max abs err {err})"
    return err


def phase_select_kernel(items, card: str):
    """Phase 26: the select kernel against its plain version on the card,
    on the match kernel's (ml, dist) of the L6 pass's windows, of zeros
    and random windows and of the trap windows, on the L4 pass's windows
    at the L4 and L1 flags, and on the seeded edge arrays at the three
    callers' flags; then its record, timed on the L6 pass's windows.
    Returns the record."""
    import numpy as np
    import torch
    from _port_corpus import l6_windows, select_cases, select_tile_cases
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops import select as sl
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import find_matches_v2

    def l6_inputs(rows, valid, hist, s):
        return (*ml6.find_matches_l6(rows, valid, hist, s), valid.long(),
                rows)

    rows, valid, hist, s = l6_windows_of(items, SLICE)
    main = l6_inputs(rows, valid, hist, s)
    errs = [select_vs_plain(*main, True, "the corpus windows")]
    rng = np.random.default_rng(26)
    edge = [bytes(2 * SLICE), rng.integers(0, 256, 2 * SLICE - 999,
                                           dtype=np.uint8).tobytes()]
    errs.append(select_vs_plain(*l6_inputs(*l6_windows_of(edge, SLICE)),
                                True, "zeros and random windows"))
    labels, t_rows, t_valid, t_hist, t_s = l6_windows()
    errs.append(select_vs_plain(*l6_inputs(
        *(torch.from_numpy(x).cuda() for x in (t_rows, t_valid, t_hist)),
        t_s), True, "the trap windows"))
    _, arr, valid4, _, _ = gd.split_many(items, SLICE, False)
    arr, valid4 = torch.from_numpy(arr).cuda(), \
        torch.from_numpy(valid4).cuda().long()
    ml4, dist4 = find_matches_v2(arr, valid4, SLICE)
    errs.append(select_vs_plain(ml4, dist4, valid4, arr, False,
                                "the L4 windows"))
    errs.append(select_vs_plain(ml4, dist4, valid4, None, False,
                                "the L4 windows at the L1 flags"))
    # the tile-edge arrays sit at the tile edges of the flags' payload
    edge = select_cases()
    tile_edge = {start: select_tile_cases(start) for start in (gd.HIST, 0)}
    for l6, hist in ((True, True), (False, True), (False, False)):
        for _, *arrays in (edge, tile_edge[gd.HIST if l6 else 0]):
            e_ml, e_dist, e_valid, e_data = (torch.from_numpy(x).cuda()
                                             for x in arrays)
            errs.append(select_vs_plain(e_ml, e_dist, e_valid,
                                        e_data if hist else None, l6,
                                        "the edge arrays"))
    e_labels = edge[0] + tile_edge[0][0]
    log(f"select vs plain: equal on the {rows.shape[0]} corpus windows "
        f"(s = {s}), 2 zeros and 2 random windows of that width, "
        f"{len(labels)} trap windows (s = {t_s}), the {arr.shape[0]} L4 "
        f"windows at the L4 and L1 flags and {len(e_labels)} edge and "
        f"tile-edge arrays at the three flags ({', '.join(e_labels)}), "
        f"max abs err {max(errs)}")
    # one L1 per-item pass's windows (the first item's, cells of 64, no
    # histograms) and the L4 pass's, timed beside the record
    arr1, valid1, _, _ = gs.split_blocks(items[0], SLICE)
    arr1, valid1 = torch.from_numpy(arr1).cuda(), \
        torch.from_numpy(valid1).cuda().long()
    ml1, dist1 = find_matches_v2(arr1, valid1, SLICE)
    errs.append(select_vs_plain(ml1, dist1, valid1, None, False,
                                "an L1 pass's windows"))
    for label, args in ((f"an L1 pass's {arr1.shape[0]} windows",
                         (ml1, dist1, valid1, None)),
                        (f"the L4 pass's {arr.shape[0]} windows",
                         (ml4, dist4, valid4, arr))):
        t = time_cuda(lambda: sl.select(*args), KERNEL_REPS)
        log(f"select on {label}: kernel {t:.4f} ms (CUDA events, "
            f"{KERNEL_REPS} calls) [{card}]")
    ms = time_cuda(lambda: sl.select(*main, l6=True), KERNEL_REPS)
    plain_ms = time_cuda(lambda: sl.select_plain(*main, l6=True),
                         KERNEL_REPS)
    b, n = rows.shape[0], s - gd.HIST
    # (ml, dist) and the byte in, ml, sel and lit out per payload
    # position; valid_len in and the two histograms out per window
    nbytes = b * n * (8 + 8 + 1 + 8 + 1 + 1) + b * (8 + 2 * (288 + 30))
    log(f"select on the {b} corpus windows: kernel {ms:.3f} ms, plain "
        f"version {plain_ms:.3f} ms on the card (CUDA events, "
        f"{KERNEL_REPS} calls each) [{card}]")
    return record("select", "ops/encode_v2.py:168", max(errs), ms,
                  plain_ms, nbytes)


def emit_vs_plain(lanes, tables, label: str) -> int:
    """The emit kernel and its plain version on the card on the same
    inputs: rows (every padding byte), byte_off, row_bit0 and end_bits
    equal. Returns the max abs err."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import emit as em

    got = em.emit(*lanes, *tables)
    want = em.emit_plain(*lanes, *tables)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want)), \
        f"emit {label}: kernel != plain (max abs err {err})"
    return err


def emit_bytes(lanes, tables) -> int:
    """Bytes the emit must move once on these inputs, counted from their
    tokens: in, every lane's sel flag, the lit flag of each lane not sel,
    the byte of each literal (lit and not sel) and int64 (ml, dist) of
    each sel lane (a match's length and the offset that rides the next
    lane), per block the tables and start bits (dynamic mode); out, each
    row's buffer and int64 byte_off and row_bit0, and end_bits."""
    _, _, _, sel, lit, s = lanes
    b = sel.shape[0]
    n_sel = int(sel.sum())
    n_lit = int((lit & ~sel).sum())
    row_out = 64 if tables else 48
    return b * s + (b * s - n_sel) + n_lit + 16 * n_sel \
        + b * (s // 32) * (row_out + 1 + 16) \
        + b * ((288 + 30) * 4 + 8 if tables else 0) + b * 8


def phase_emit_kernel(items, card: str):
    """Phase 28: the emit kernel against its plain version on the card,
    on the L6 pass's 259 blocks, the L4 pass's and one L1 per-item pass's
    (static mode), zeros and random blocks at L6 and L1, and the seeded
    trap, overflowing and tile-edge arrays of tests/_port_corpus.py in
    both modes, as they are and through emit_unaligned's views (every
    row off 16 bytes); its launch
    shape on the three passes; then its record, timed on the L6 pass, and
    its times on the L4 and L1 passes. Returns the record."""
    import numpy as np
    import torch
    from _port_corpus import (emit_cases, emit_chunk_cases,
                              emit_pass_inputs, emit_random_cases,
                              emit_unaligned)
    from libdeflate_rsx_tpu_torch.ops import emit as em

    main = emit_pass_inputs(items, 6, SLICE, "cuda")
    errs = [emit_vs_plain(*main, "the L6 pass")]
    l4 = emit_pass_inputs(items, 4, SLICE, "cuda")
    errs.append(emit_vs_plain(*l4, "the L4 pass"))
    l1 = emit_pass_inputs(items[:1], 1, SLICE, "cuda")
    errs.append(emit_vs_plain(*l1, "an L1 pass"))
    for label, (lanes, tables) in (("the L6 pass", main), ("the L4 pass", l4),
                                   ("an L1 pass", l1)):
        shape = em.launch_shape(lanes[1].shape[0], lanes[5], bool(tables))
        log(f"emit launch on {label}: tiles of {shape['tile']} lanes, "
            f"{shape['blocks']} blocks of 256 threads, {shape['resident']} "
            f"resident an SM, {shape['registers']} registers a thread, "
            f"{shape['shared']} B of dynamic shared memory a block")
    rng = np.random.default_rng(28)
    edge = [bytes(2 * SLICE), rng.integers(0, 256, 2 * SLICE - 999,
                                           dtype=np.uint8).tobytes()]
    for level in (6, 1):
        errs.append(emit_vs_plain(
            *emit_pass_inputs(edge, level, SLICE, "cuda"),
            f"zeros and random blocks at L{level}"))
    labels = []
    for make in (emit_cases, emit_random_cases, emit_chunk_cases):
        case = make()
        labels += case[0]
        lanes = (*(torch.from_numpy(x).cuda() for x in case[1:6]),
                 case[2].shape[1])
        tables = tuple(torch.from_numpy(x).cuda() for x in case[6:])
        odd = (*emit_unaligned(*lanes[:5]), lanes[5])
        for form, ls in (("", lanes), (", rows off 16 bytes", odd)):
            errs.append(emit_vs_plain(ls, tables, f"the edge arrays{form}"))
            errs.append(emit_vs_plain(ls, (),
                                      f"the edge arrays, static{form}"))
    b = main[0][1].shape[0]
    log(f"emit vs plain: equal on the L6 pass's {b} blocks, the L4 pass's "
        f"{l4[0][1].shape[0]} and an L1 pass's {l1[0][1].shape[0]}, 2 "
        f"zeros and 2 random blocks at L6 and L1, and {len(labels)} edge, "
        f"overflowing and tile-edge arrays in both modes, as they are and "
        f"with every row off 16 bytes ({', '.join(labels)}), max abs err "
        f"{max(errs)}")
    for label, (lanes, tables) in (
            (f"an L1 pass's {l1[0][1].shape[0]} blocks", l1),
            (f"the L4 pass's {l4[0][1].shape[0]} blocks", l4)):
        t = time_cuda(lambda: em.emit(*lanes, *tables), KERNEL_REPS)
        tp = time_cuda(lambda: em.emit_plain(*lanes, *tables), KERNEL_REPS)
        log(f"emit on {label}: kernel {t:.4f} ms, plain version {tp:.3f} "
            f"ms (CUDA events, {KERNEL_REPS} calls each); bound "
            f"{emit_bytes(lanes, tables) / HBM_BYTES_PER_MS:.6f} ms [{card}]")
    ms = time_cuda(lambda: em.emit(*main[0], *main[1]), KERNEL_REPS)
    plain_ms = time_cuda(lambda: em.emit_plain(*main[0], *main[1]),
                         KERNEL_REPS)
    nbytes = emit_bytes(*main)
    sel = main[0][3]
    log(f"emit on the L6 pass's {b} blocks: kernel {ms:.3f} ms, plain "
        f"version {plain_ms:.3f} ms on the card (CUDA events, "
        f"{KERNEL_REPS} calls each); {int(sel.sum())} of {sel.numel()} "
        f"lanes sel [{card}]")
    return record("emit", "ops/encode_dynamic.py:89", max(errs), ms,
                  plain_ms, nbytes)


def v2_vs_plain(rows, valid, s, label: str) -> int:
    """The L1-5 match kernel (find_matches_v2 on the card, one launch)
    and its plain version on the card on the same blocks: ml and dist
    equal. Returns the max abs err."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import (find_matches_v2,
                                                        find_matches_v2_plain)

    before = mv2.LAUNCHES
    got = find_matches_v2(rows, valid, s)
    assert mv2.LAUNCHES == before + (rows.shape[0] > 0), \
        f"match_v2 {label}: not one launch"
    want = find_matches_v2_plain(rows, valid, s)
    torch.cuda.synchronize()
    err = max(int((g - w).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    assert all(g.dtype == torch.int64 and torch.equal(g, w)
               for g, w in zip(got, want)), \
        f"match_v2 {label}: kernel != plain (max abs err {err})"
    return err


def v2_bytes(rows, s) -> int:
    """Bytes the L1-5 match finder must move once: each block's s bytes
    and the 7 past it that its last words read, int64 valid_len, and
    int64 (ml, dist) of every position out."""
    b = rows.shape[0]
    return b * (s + 7) + 8 * b + 16 * b * s


def phase_v2_match_kernel(items, card: str):
    """Phase 29: the L1-5 match kernel against its plain version on the
    card, on the L4 pass's blocks of the corpus items, one L1 per-item
    pass's blocks, zeros and random blocks, and the seeded trap blocks
    of the CPU tests at every size; then its record, timed on the L4
    pass, and its time on the L1 pass. Returns the record."""
    import numpy as np
    import torch
    from _port_corpus import V2_SIZES, v2_cases
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.models import greedy_static as gs
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import (find_matches_v2,
                                                        find_matches_v2_plain)

    def on_card(*arrays):
        return tuple(torch.from_numpy(x).cuda() for x in arrays)

    def escaping(rows, valid, s, label):
        """v2_vs_plain, and the windows of the launch that took the sort
        by the whole word."""
        mv2.reset_escapes()
        errs.append(v2_vs_plain(rows, valid, s, label))
        return mv2.escapes()

    errs = []
    _, arr, valid, _, _ = gd.split_many(items, SLICE, False)
    l4 = on_card(arr, valid)
    esc4 = escaping(*l4, SLICE, "the L4 pass")
    arr1, valid1, _, _ = gs.split_blocks(items[0], SLICE)
    l1 = on_card(arr1, valid1)
    esc1 = escaping(*l1, SLICE, "an L1 pass")
    assert esc4 == esc1 == 0, \
        f"match_v2: {esc4} L4 and {esc1} L1 windows took the word sort"
    rng = np.random.default_rng(29)
    edge = [bytes(2 * SLICE), rng.integers(0, 256, 2 * SLICE - 999,
                                           dtype=np.uint8).tobytes()]
    _, e_arr, e_valid, _, _ = gd.split_many(edge, SLICE, False)
    errs.append(v2_vs_plain(*on_card(e_arr, e_valid), SLICE,
                            "zeros and random blocks"))
    n_traps = n_esc = 0
    for s in V2_SIZES:
        labels, t_rows, t_valid = v2_cases(s)
        want = sum("(escape)" in x for x in labels) * (2 if s > 65536 else 1)
        got = escaping(*on_card(t_rows, t_valid), s,
                       f"the trap blocks of {s} bytes")
        # the same blocks in batches that fit one round of 8-block clusters
        step = max(1, mv2.launch_shape(s, 1)[2] // len(mv2.windows(s)))
        got8 = 0
        for i in range(0, len(labels), step):
            assert mv2.launch_shape(s, len(labels[i:i + step]))[0] == 8
            got8 += escaping(*on_card(t_rows[i:i + step],
                                      t_valid[i:i + step]), s,
                             f"the trap blocks of {s} bytes from {i}")
        assert got == got8 == want, \
            f"match_v2 traps of {s} bytes: {got} and {got8} windows took " \
            f"the word sort, not {want}"
        n_traps += len(labels)
        n_esc += got
    assert n_esc >= 1
    log(f"match_v2 vs plain: equal at every position of the L4 pass's "
        f"{arr.shape[0]} blocks, an L1 pass's {arr1.shape[0]}, 2 zeros and "
        f"2 random blocks and {n_traps} trap blocks (sizes "
        f"{', '.join(map(str, V2_SIZES))}; again in batches of 8-block "
        f"clusters), max abs err {max(errs)}; windows sorted by the whole "
        f"word: L4 pass {esc4}, L1 pass {esc1}, the escape traps {n_esc}")
    for label, rows in (("the L4 pass", arr), ("an L1 pass", arr1)):
        size, smem, clusters, rounds = mv2.launch_shape(SLICE, rows.shape[0])
        log(f"match_v2 launch on {label}'s {rows.shape[0]} blocks: "
            f"clusters of {size} blocks ({smem} B of shared memory each), "
            f"{clusters} resident, {rounds} rounds")
    size, smem, clusters, rounds = mv2.launch_shape(SLICE, arr.shape[0])
    t1 = time_cuda(lambda: find_matches_v2(*l1, SLICE), KERNEL_REPS)
    tp1 = time_cuda(lambda: find_matches_v2_plain(*l1, SLICE), KERNEL_REPS)
    log(f"match_v2 on an L1 pass's {arr1.shape[0]} blocks: kernel "
        f"{t1:.4f} ms, plain version {tp1:.3f} ms (CUDA events, "
        f"{KERNEL_REPS} calls each); bound "
        f"{v2_bytes(arr1, SLICE) / HBM_BYTES_PER_MS:.6f} ms [{card}]")
    ms = time_cuda(lambda: find_matches_v2(*l4, SLICE), KERNEL_REPS)
    plain_ms = time_cuda(lambda: find_matches_v2_plain(*l4, SLICE),
                         KERNEL_REPS)
    b = arr.shape[0]
    log(f"match_v2 on the L4 pass's {b} blocks: kernel {ms:.3f} ms, plain "
        f"version {plain_ms:.3f} ms on the card (CUDA events, "
        f"{KERNEL_REPS} calls each); clusters of {size} blocks ({smem} B "
        f"of shared memory each), {clusters} resident, {rounds} rounds "
        f"[{card}]")
    return record("match_v2", "ops/encode_v2.py:73", max(errs), ms,
                  plain_ms, v2_bytes(arr, SLICE))


def checksum_vs_plain(kernel, plain, args, label: str) -> int:
    """The kernel and its plain version on the card on the same inputs:
    equal, or the phase fails. Returns the max abs difference (0)."""
    got, want = kernel(*args), plain(*args)
    assert got.shape == want.shape, f"checksums on {label}: shapes differ"
    err = int((got - want).abs().max()) if got.numel() else 0
    assert err == 0, f"checksums on {label}: kernel != plain (max abs " \
        f"err {err})"
    return err


def phase_checksum_kernel(data: bytes, card: str):
    """Phase 30: the checksum kernel (csrc/checksums.cu) against its plain
    versions on the card: crc32_blocks and adler32_blocks on the corpus's
    64 KiB rows with their int32 lengths (the sharded static tier's
    call) and on the trap rows of tests/_port_corpus.py (every span
    boundary +-1, the head and tail lengths, all-0x00 and all-0xFF rows;
    int32 and int64 lengths), its rows wider than a tile (again after a
    narrow batch), all-0xFF rows of one to three tiles, rows at an odd
    stride and the corpus as the compress items' 17 rows of 1 MiB;
    crc32_fixed and adler32_fixed on the trap buffers at every trap
    initial value and on the whole corpus, with and without an initial
    value (crc32_device and adler32_device equal to zlib), a buffer twice
    in a row and on two streams, every state left zeroed; the corpus as
    one buffer timed, each in one kernel launch; then each of
    crc32_blocks and adler32_blocks timed on the corpus's rows beside
    its plain version, and on the 17 rows of 1 MiB. The record is the
    pair as
    the sharded path calls it: ms and plain_ms summed, the bound the
    bytes each of the two calls must move (the corpus bytes, the int32
    lengths, the int64 registers)."""
    import numpy as np
    import torch
    from _port_corpus import (CHECKSUM_INITS, CHECKSUM_WIDTHS,
                              checksum_buffers, checksum_ff_rows,
                              checksum_odd_stride, checksum_rows,
                              checksum_wide_rows)
    from libdeflate_rsx_tpu_torch.ops import checksums as ck

    pairs = (("crc32_blocks", ck.crc32_blocks, ck.crc32_blocks_plain,
              zlib.crc32),
             ("adler32_blocks", ck.adler32_blocks, ck.adler32_blocks_plain,
              zlib.adler32))
    nblk = -(-len(data) // SLICE)
    arr = np.zeros(nblk * SLICE, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    rows = torch.from_numpy(arr.reshape(nblk, SLICE)).cuda()
    lengths = torch.tensor([min(SLICE, len(data) - i * SLICE)
                            for i in range(nblk)], dtype=torch.int32,
                           device="cuda")
    blocks = [data[i * SLICE:(i + 1) * SLICE] for i in range(nblk)]
    err = 0
    for name, kernel, plain, ref in pairs:
        err = max(err, checksum_vs_plain(kernel, plain, (rows, lengths),
                                         f"the corpus's {nblk} rows"))
        assert kernel(rows, lengths).cpu().tolist() == \
            [ref(b) for b in blocks], f"{name} != zlib"
    ntrap = 0
    for width in CHECKSUM_WIDTHS:
        trap, lens = checksum_rows(width)
        t = torch.from_numpy(trap).cuda()
        for n in (torch.from_numpy(lens).cuda(),
                  torch.from_numpy(lens.astype(np.int32)).cuda()):
            for name, kernel, plain, ref in pairs:
                err = max(err, checksum_vs_plain(
                    kernel, plain, (t, n), f"the trap rows at {width}"))
        for name, kernel, plain, ref in pairs:
            assert kernel(t, n).cpu().tolist() == \
                [ref(r[:k].tobytes()) for r, k in zip(trap, lens)], \
                f"{name} on the trap rows at {width} != zlib"
        ntrap += len(trap)
    wide, lens = checksum_wide_rows()
    t, n = torch.from_numpy(wide).cuda(), torch.from_numpy(lens).cuda()
    for name, kernel, plain, ref in pairs:
        err = max(err, checksum_vs_plain(kernel, plain, (t, n),
                                         f"{len(wide)} rows wider than a "
                                         f"CRC tile"))
        assert kernel(t, n).cpu().tolist() == \
            [ref(r[:k].tobytes()) for r, k in zip(wide, lens)], \
            f"{name} on the wide rows != zlib"
    # the Adler traps of the tile design: all-0xFF rows of 1-3 tiles, rows
    # at an odd stride with random bytes past each length (the plain
    # versions on the zero-padded rows), the compress items' 17 rows of
    # 1 MiB; a wide batch again after a narrow one
    ff, ff_lens = checksum_ff_rows()
    store, odd_lens = checksum_odd_stride()
    odd = np.where(np.arange(store.shape[1] - 1) < odd_lens[:, None],
                   store[:, :-1], 0).astype(np.uint8)
    nitem = -(-len(data) // ITEM)
    items = np.zeros((nitem, ITEM), np.uint8)
    items.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
    item_lens = np.array([min(ITEM, len(data) - i * ITEM)
                          for i in range(nitem)], np.int64)
    odd_view = torch.from_numpy(store).cuda()[:, :-1]
    assert odd_view.stride(0) % 2 == 1
    sets = (("all-0xFF rows of 1-3 tiles", ff, ff_lens,
             torch.from_numpy(ff).cuda()),
            ("rows at an odd stride", odd, odd_lens, odd_view),
            (f"the corpus as {nitem} rows of 1 MiB", items, item_lens,
             torch.from_numpy(items).cuda()))
    for label, zeroed, lens, view in sets:
        n = torch.from_numpy(lens).cuda()
        for name, kernel, plain, ref in pairs:
            got = kernel(view, n)
            err = max(err, checksum_vs_plain(
                lambda *_: got, plain, (torch.from_numpy(zeroed).cuda(), n),
                label))
            assert got.cpu().tolist() == \
                [ref(r[:k].tobytes()) for r, k in zip(zeroed, lens)], \
                f"{name} on {label} != zlib"
    t = torch.from_numpy(wide).cuda()
    w_lens = torch.from_numpy(checksum_wide_rows()[1]).cuda()
    first = ck.adler32_blocks(t, w_lens)
    ck.adler32_blocks(torch.from_numpy(checksum_rows(5120)[0]).cuda(),
                      torch.from_numpy(checksum_rows(5120)[1]).cuda())
    assert torch.equal(ck.adler32_blocks(t, w_lens), first), \
        "adler32_blocks on wide rows differs after a narrow batch"
    fixed = (("crc32_fixed", ck.crc32_fixed, ck.crc32_fixed_plain,
              zlib.crc32),
             ("adler32_fixed", ck.adler32_fixed, ck.adler32_fixed_plain,
              zlib.adler32))
    bufs = checksum_buffers() + [data]
    for buf in bufs:
        t = ck._padded(buf, ck.CRC_CHUNK, "cuda")
        inits = CHECKSUM_INITS if len(buf) < len(data) else (0, 1,
                                                             0xFFF0FFF0)
        for init in inits:
            for name, kernel, plain, ref in fixed:
                err = max(err, checksum_vs_plain(
                    kernel, plain, (t, len(buf), init),
                    f"a buffer of {len(buf)} bytes from {init:#x}"))
                assert int(kernel(t, len(buf), init)) == ref(buf, init), \
                    f"{name} of {len(buf)} bytes from {init:#x} != zlib"
    a, b = data[:len(data) // 3], data[len(data) // 3:]
    assert ck.crc32_device(b, zlib.crc32(a)) == zlib.crc32(data)
    assert ck.adler32_device(b, zlib.adler32(a)) == zlib.adler32(data)
    # the buffer route's state: two calls in a row, and calls on two streams
    big = checksum_buffers()[0]
    buf = ck._padded(big, ck.CRC_CHUNK, "cuda")
    want = [zlib.adler32(big, 5), zlib.crc32(big, 5)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for s in [None, None] + streams:
        with torch.cuda.stream(s or torch.cuda.current_stream()):
            outs.append((ck.adler32_fixed(buf, len(big), 5),
                         ck.crc32_fixed(buf, len(big), 5)))
    torch.cuda.synchronize()
    assert all([int(x) for x in o] == want for o in outs), \
        "a buffer's checksums differ across calls or streams"
    log(f"checksums kernel on the corpus's {nblk} rows, {ntrap} trap rows "
        f"at widths {CHECKSUM_WIDTHS} (int32 and int64 lengths), "
        f"{len(wide)} rows of {wide.shape[1]} bytes (again after a narrow "
        f"batch), {len(ff)} all-0xFF rows, {len(odd)} rows at an odd "
        f"stride, the corpus as {nitem} rows of 1 MiB, {len(bufs)} buffers "
        f"(the corpus among them) at their initial values, a buffer twice "
        f"and on two streams: equal to the plain versions and to zlib (max "
        f"abs err {err}); every state left zeroed")
    assert not any(st.any() for st in ck._STATE.values())
    buf = ck._padded(data, ck.CRC_CHUNK, "cuda")
    for name, fn in (("crc32_fixed", ck.crc32_fixed),
                     ("adler32_fixed", ck.adler32_fixed)):
        dev = kernel_times(lambda: fn(buf, len(data), 1), KERNEL_REPS)
        k_ms = time_cuda(lambda: fn(buf, len(data), 1), KERNEL_REPS)
        log(f"{name} of the corpus as one buffer: {k_ms:.4f} ms (CUDA "
            f"events, {KERNEL_REPS} calls); device µs a call "
            f"(torch.profiler): " + ", ".join(
                f"{k} {v:.2f}" for k, v in sorted(dev.items()))
            + f" [{card}]")
        kind = "crc_kernel" if name == "crc32_fixed" else "adler_kernel"
        assert len(dev) == 1 and kind in next(iter(dev)), \
            f"the {name} buffer route launched {sorted(dev)}"
    del buf
    nbytes = len(data) + 4 * nblk + 8 * nblk
    ms = plain_ms = 0.0
    for name, kernel, plain, _ in pairs:
        k_ms = time_cuda(lambda: kernel(rows, lengths), KERNEL_REPS)
        p_ms = time_cuda(lambda: plain(rows, lengths), KERNEL_REPS)
        dev = kernel_times(lambda: kernel(rows, lengths), KERNEL_REPS)
        log(f"{name} on the corpus's {nblk} rows of 64 KiB: kernel "
            f"{k_ms:.4f} ms, plain version {p_ms:.3f} ms on the card (CUDA "
            f"events, {KERNEL_REPS} calls each, the rows warm in L2); bound "
            f"{nbytes / HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes); device "
            f"µs a call (torch.profiler): "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(dev.items()))
            + f" [{card}]")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
    rows = torch.from_numpy(items).cuda()
    lengths = torch.from_numpy(item_lens).cuda()
    i_bytes = len(data) + 16 * nitem
    for name, kernel, plain, _ in pairs:
        k_ms = time_cuda(lambda: kernel(rows, lengths), KERNEL_REPS)
        p_ms = time_cuda(lambda: plain(rows, lengths), KERNEL_REPS)
        log(f"{name} on the corpus as {nitem} rows of 1 MiB (the compress "
            f"items): kernel {k_ms:.4f} ms, plain version {p_ms:.3f} ms on "
            f"the card (CUDA events, {KERNEL_REPS} calls each); bound "
            f"{i_bytes / HBM_BYTES_PER_MS:.6f} ms ({i_bytes} bytes) "
            f"[{card}]")
    del rows
    for name, fn in (("crc32_device", ck.crc32_device),
                     ("adler32_device", ck.adler32_device)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(data)
        log(f"{name} of the corpus ({len(data)} bytes): wall "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, the "
            f"copy to the card included) [{card}]")
    return record("checksums", "ops/checksums.py:258", err, ms, plain_ms,
                  2 * nbytes)


def phase_resolve_tokens(slices, chunks, rec_rs: dict, card: str) -> None:
    """Phase 27a: ops.resolve.resolve_tokens_device on pass 1's token
    columns of the 256 zlib-6 slices at the 64 KiB out_cap, on the card:
    every output its slice, exactly one resolve-kernel launch, the bytes
    equal to resolve_batch_plain's on the card; then timed (CUDA events)
    beside resolve_batch alone on the same columns."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    tok, _ = pass1_columns(slices, SLICE)
    run = rs.LAUNCHES
    got = rs.resolve_tokens_device(tok, SLICE)
    assert rs.LAUNCHES - run == 1, \
        f"resolve_tokens_device launched the kernel {rs.LAUNCHES - run} times"
    bad = [i for i, (g, c) in enumerate(zip(got, chunks)) if g != c]
    assert len(got) == len(chunks) and not bad, \
        f"resolve_tokens_device: slices {bad[:10]} differ"
    out, outlen, ok = rs.resolve_batch_plain(tok, SLICE)
    out, outlen, ok = out.cpu().numpy(), outlen.tolist(), ok.tolist()
    plain = [out[i, :outlen[i]].tobytes() if ok[i] else None
             for i in range(len(ok))]
    assert got == plain, "resolve_tokens_device != the plain version"
    ms = time_cuda(lambda: rs.resolve_tokens_device(tok, SLICE), KERNEL_REPS)
    kernel_ms = time_cuda(lambda: rs.resolve_batch(tok, SLICE), KERNEL_REPS)
    log(f"resolve_tokens_device on pass 1's tokens of the {len(chunks)} "
        f"zlib-6 slices (out_cap {SLICE}): every output its slice, equal "
        f"to the plain version on the card, 1 kernel launch; {ms:.3f} ms a "
        f"call with its copies to the host, resolve_batch alone on the "
        f"same columns {kernel_ms:.3f} ms (CUDA events, {KERNEL_REPS} calls "
        f"each; phase 24's record on the L6 items {rec_rs['ms']:.3f} ms) "
        f"[{card}]")


#: phase 27b: (example, arguments); torch_manual_bench at 1 MiB, since
#: its default 4 MiB takes ~26 s on the port's pure-Python host codec
EXAMPLES = (("torch_basics", ()), ("torch_batch", ()),
            ("torch_checksums", ()), ("torch_gzip_zlib", ()),
            ("torch_streaming", ()),
            ("torch_manual_bench", ("--size", str(ITEM))),
            ("torch_device_tiers", ()), ("torch_sharded", ()),
            ("torch_multihost_global", ()))
EXAMPLE_TIMEOUT = 300   # seconds for each example


def phase_examples(card: str) -> None:
    """Phase 27b: every examples/torch_*.py as its own `python3 <file>`
    process on the card, all started together, each with its own
    timeout (its process group killed past it); each must exit 0. Logs
    each one's last stdout line and seconds."""
    import signal

    import torch

    torch.cuda.empty_cache()
    d = os.path.join(ROOT, "build", "smoke_examples")
    os.makedirs(d, exist_ok=True)
    runs = {}
    for name, args in EXAMPLES:
        out = open(os.path.join(d, name + ".log"), "w+")
        runs[name] = (subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", name + ".py"),
             *args], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            text=True, start_new_session=True), out, time.perf_counter())
    walls, failed = {}, []
    try:
        while len(walls) < len(runs):
            for name, (p, _, t0) in runs.items():
                if name in walls:
                    continue
                if p.poll() is None and \
                        time.perf_counter() - t0 > EXAMPLE_TIMEOUT:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
                if p.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for p, out, _ in runs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for name, (p, out, _) in runs.items():
        out.seek(0)
        text = out.read()
        out.close()
        lines = text.strip().splitlines() or [""]
        log(f"example {name}.py: exit {p.returncode} in {walls[name]:.1f} s;"
            f" last line: {lines[-1]}")
        if p.returncode != 0:
            failed.append(f"{name}.py (exit {p.returncode}):\n"
                          f"{text[-3000:]}")
    assert not failed, "examples failed:\n" + "\n".join(failed)
    log(f"examples: {len(runs)} of {len(runs)} exit 0 [{card}]")


def phase_trace(data: bytes, card: str) -> None:
    """Phase 27c: utils.profiling.device_trace around one
    BatchCompressor(level=6, use_device=True).compress_batch of one 1 MiB
    corpus item inside trace("l6_item"): the Chrome trace file must name
    the span and hold a launch of the match or the select kernel. A trace
    that records no kernel at all (the profiler drops the device's
    activity at random on the card machine, see `kernel_times`) is taken
    again, up to 3 times."""
    import glob
    import shutil

    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.utils.profiling import device_trace, trace

    bc = BatchCompressor(level=6, use_device=True, device="cuda")
    item = data[:ITEM]
    want = ("match_l6_kernel", "select_kernel")
    for attempt in range(1, 4):
        d = os.path.join(ROOT, "build", "smoke_trace")
        shutil.rmtree(d, ignore_errors=True)
        with device_trace(d):
            with trace("l6_item"):
                out = bc.compress_batch([item])
        assert zlib.decompress(out[0], -15) == item, "l6_item round trip"
        (path,) = glob.glob(os.path.join(d, "*.json"))
        events = json.load(open(path))["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    spans = [e for e in events if e.get("name") == "l6_item"]
    ours = sorted({w for w in want for k in kernels if w in k})
    assert spans, "the trace file does not name the l6_item span"
    assert ours, f"no match or select kernel in the trace: {kernels[:20]}"
    log(f"device_trace of one L6 item (attempt {attempt}): "
        f"{os.path.basename(path)} holds the l6_item span and "
        f"{', '.join(ours)} among {len(kernels)} kernel events [{card}]")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from libdeflate_rsx_tpu_torch.ops import assemble as asm
    from libdeflate_rsx_tpu_torch.ops import checksums as ck
    from libdeflate_rsx_tpu_torch.ops import dyn_tables as dtab
    from libdeflate_rsx_tpu_torch.ops import emit as em
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops import match_v2 as mv2
    from libdeflate_rsx_tpu_torch.ops import resolve as rs
    from libdeflate_rsx_tpu_torch.ops import select as sl

    card = phase_card()
    phase_build()
    data = corpus()
    rec = phase_kernel(data)

    it.LAUNCHES = rs.LAUNCHES = 0         # the main path starts here
    dtab.LAUNCHES = asm.LAUNCHES = ml6.LAUNCHES = sl.LAUNCHES = 0
    em.LAUNCHES = 0
    with counting_phases() as phases:
        items, comp = phase_compress(data)
    passes = phases["assemble"]
    launches_tail = (dtab.LAUNCHES, asm.LAUNCHES)
    launches_ml6, launches_sl = ml6.LAUNCHES, sl.LAUNCHES
    launches_em = em.LAUNCHES
    assert passes > 0 and launches_tail == (passes, passes) \
        and launches_ml6 == launches_sl == launches_em == passes, \
        f"the L6 compress launched match_l6 {launches_ml6} times, " \
        f"select {launches_sl} times, emit {launches_em} times, " \
        f"dyn_tables/assembly {launches_tail} in {passes} passes"
    log(f"match_l6 launches on the L6 compress: {launches_ml6}; select "
        f"launches: {launches_sl}; emit launches: {launches_em}; "
        f"dyn_tables launches: {launches_tail[0]}; assembly launches: "
        f"{launches_tail[1]} ({passes} device passes)")
    phase_compress_cpu(items, comp)
    comp_l6 = comp
    counts = route_counts()
    phase_decompress("L6 items", comp, items, [ITEM] * len(comp))
    counts = route_counts(counts)
    chunks = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    slices = [raw_z(c) for c in chunks]
    counts_sl = route_counts()
    phase_decompress("zlib-6 slices", slices, chunks, [SLICE] * N_SLICES)
    counts_sl = route_counts(counts_sl)
    rec["launches"] = it.LAUNCHES
    launches_rs = rs.LAUNCHES
    assert rec["launches"] > 0, "the main path never launched pass 1"
    assert launches_rs > 0, "the main path never launched resolve"
    log(f"pass-1 kernel launches on the main path: {rec['launches']}; "
        f"resolve kernel launches: {launches_rs}")
    log(f"segment route on the {len(comp)} L6 items: {counts}; on the "
        f"{N_SLICES} slices: {counts_sl}")
    assert counts["SEGMENTS"] > len(comp) and counts["RERUNS"] == 0, counts
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    phase_pass1_routes(comp, ITEM, f"the {len(comp)} L6 items (out_cap 1 MiB)")
    phase_pass1_routes(slices, SLICE,
                       f"the {N_SLICES} zlib-6 slices (out_cap 64 KiB)")
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             phase_kernel_items(data, comp))

    rec_v2 = phase_v2_kernel(data)
    v2.LAUNCHES = it.LAUNCHES = 0          # the small-batch path starts here
    phase_small_batch(data)
    rec_v2["launches"] = v2.LAUNCHES
    assert rec_v2["launches"] > 0, "the small-batch path never launched v2"
    assert it.LAUNCHES == 0, "the small-batch path launched pass 1"
    log(f"inflate_v2 launches on the small-batch path: {v2.LAUNCHES} "
        f"(pass 1: {it.LAUNCHES})")

    rec_st = phase_static_kernel(data)
    st.LAUNCHES = 0                         # the static path starts here
    phase_static_path(data)
    rec_st["launches"] = st.LAUNCHES
    assert rec_st["launches"] > 0, "the static path never launched its kernel"
    log(f"inflate_static launches on the static path: {st.LAUNCHES}")

    t_tiers = time.perf_counter()
    items, comp, launches_v2m = phase_compress_tiers(data)
    mv2.LAUNCHES = 0                    # the slices' compress starts here
    sliced = tier_slices(data)
    sliced_v2m = mv2.LAUNCHES
    assert sliced_v2m >= 2, f"the slices' L1 and L4 compress launched " \
        f"match_v2 {sliced_v2m} times"
    phase_decode_tiers(data, items, comp, sliced)
    phase_small_tiers(data, sliced)
    rec_st["max_abs_err"] = max(rec_st["max_abs_err"],
                                phase_static_tier(data, sliced))
    assert mv2.LAUNCHES == sliced_v2m, "a decode phase launched match_v2"
    log(f"match_v2 launches: {launches_v2m} on the L1 and L4 compress of "
        f"the items (two runs each), {sliced_v2m} on the slices' compress, "
        f"none in phases 14-16")
    phase_checksums(data)
    log(f"phases 13-17 (the level 0-5 tiers and the checksums): "
        f"{time.perf_counter() - t_tiers:.1f} s")

    t_shard = time.perf_counter()
    items = [data[i:i + ITEM] for i in range(0, len(data), ITEM)]
    singles, coefs = phase_budget_coefficients(data, items, comp_l6, card)
    phase_budget_over(items, singles, coefs, card)
    log(f"phase 18 (the memory budget): "
        f"{time.perf_counter() - t_shard:.1f} s")
    t_shard = time.perf_counter()
    ck.LAUNCHES = 0                     # the sharded compress starts here
    expect, launches_ck = phase_sharded_nccl(data, items, card)
    it.LAUNCHES = 0                     # the sharded decode starts here
    phase_sharded_decode_nccl(slices, chunks, card)
    launches_shard = it.LAUNCHES
    phase_sharded_gloo(expect, data, slices, card)
    log(f"pass-1 kernel launches on the sharded decode path (NCCL x1): "
        f"{launches_shard}")
    log(f"phases 19-21 (the sharded paths): "
        f"{time.perf_counter() - t_shard:.1f} s")

    t_tail = time.perf_counter()
    l6 = device_pass(items, 6)
    rec_dt = phase_tables_kernel(items, card, l6)
    rec_dt["launches"] = launches_tail[0]
    rec_asm = phase_assembly_kernel(items, comp_l6, card, l6)
    rec_asm["launches"] = launches_tail[1]
    del l6
    log(f"phases 22-23 (the table and assembly kernels): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_rs = phase_resolve_kernel(comp_l6, slices, card)
    rec_rs["launches"] = launches_rs
    log(f"phase 24 (the resolve kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_ml6 = phase_match_kernel(items, card)
    rec_ml6["launches"] = launches_ml6
    log(f"phase 25 (the match kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_sl = phase_select_kernel(items, card)
    rec_sl["launches"] = launches_sl
    log(f"phase 26 (the select kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    phase_resolve_tokens(slices, chunks, rec_rs, card)
    phase_examples(card)
    phase_trace(data, card)
    log(f"phase 27 (resolve_tokens_device, the examples, the trace): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_em = phase_emit_kernel(items, card)
    rec_em["launches"] = launches_em
    log(f"phase 28 (the emit kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_v2m = phase_v2_match_kernel(items, card)
    rec_v2m["launches"] = launches_v2m
    log(f"phase 29 (the L1-5 match kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    t_tail = time.perf_counter()
    rec_ck = phase_checksum_kernel(data, card)
    rec_ck["launches"] = launches_ck
    log(f"phase 30 (the checksum kernel): "
        f"{time.perf_counter() - t_tail:.1f} s")
    assert "jax" not in sys.modules, "the port imported jax"
    assert not any(m.split(".")[0] == "libdeflate_rsx_tpu"
                   for m in sys.modules), "the port imported the JAX package"

    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    print(json.dumps({"kernels": [rec, rec_v2, rec_st, rec_dt, rec_asm,
                                  rec_rs, rec_ml6, rec_sl, rec_em,
                                  rec_v2m, rec_ck]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5], int(sys.argv[6]))
        sys.exit(0)
    sys.exit(main())
