#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Usage: python3 chip_smoke.py      (from the root of a checkout; one card)

Phases, in order; any failure raises and the script exits non-zero:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: the three CUDA kernels (pass 1, inflate_v2, inflate_static),
   from csrc/ with one nvcc each, all started together (build/kernels/);
3. pass 1 (the segment route's kernels) against its plain PyTorch
   version, both on the card, at the 64 KiB out_cap: zlib streams of
   every test-corpus kind and level, multi-block, garbage, truncated and
   bit-flipped streams, 16 KiB slices of the Silesia-like corpus, and
   streams with sync points (Z_SYNC_FLUSH and Z_FULL_FLUSH every few KiB,
   stored data holding 00 00 FF FF, truncated and bit-flipped ones);
   tokens and stats equal; then again on the main path's 256 zlib-6
   slices, which give the kernel's timed record and its bound;
4. compress: BatchCompressor(level=6, use_device=True) over the corpus
   in 1 MiB items, every output checked with zlib;
5. decompress: BatchDecompressor(use_device=True, resolve="device") on
   the compressed items and on 256 zlib-6 streams of 64 KiB slices,
   byte-exact with no host fallback;
6. the pass-1 kernel's launch count over phases 4-5 must be positive;
   the segment route's counts on the L6 items must show more than 17
   segments and no serial rerun;
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
   then again on the small-batch path's 7 zlib-6 slices, which give the
   kernel's timed record and its bound; the kernel alone on 256 zlib-6
   slices, and beside pass 1 on the 7 slices;
10. the small-batch path: BatchDecompressor(use_device=True) in the
   three formats on batches of 1 and 7 zlib-6 slices, byte-exact with
   no host fallback; inflate_v2's launch count over it must be positive
   and pass 1's zero;
11. inflate_static against its plain version: stored and Z_FIXED
   slices, dynamic, truncated and bit-flipped streams; every output word
   equal; then again on the static path's 128 Z_FIXED slices, which give
   the kernel's timed record and its bound;
12. the static path: inflate_device_static on 128 Z_FIXED slices,
   byte-exact; inflate_static's launch count over it must be positive.

Each kernel's record (ms, plain_ms, bound_ms) is taken on its path's
own inputs, where every input and output byte is needed: the bound is
those bytes over the card's memory rate. The last two lines are the
kernels' JSON record and the result JSON. The script exits non-zero
without a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import random
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from _port_corpus import make_corpus, mutated_streams, raw_z  # noqa: E402

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
KERNELS = ("inflate_tokens", "inflate_v2", "inflate_static")


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
    test-corpus kind and level, multi-block, garbage, truncated and
    bit-flipped streams."""
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


def phase_decompress(name, streams, originals, caps):
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor

    bd = BatchDecompressor(use_device=True, resolve="device", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = bd.decompress_batch(streams, caps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    bad = [i for i, (g, w) in enumerate(zip(got, originals)) if g != w]
    assert not bad, f"{name}: items {bad[:10]} not byte-exact"
    assert not bd.fallbacks, f"{name}: host fallbacks {dict(bd.fallbacks)}"
    log(f"decompress {name}: {len(streams)} streams, "
        f"{sum(map(len, originals))} bytes byte-exact, host fallbacks "
        f"{dict(bd.fallbacks)}; wall {dt:.3f} s")


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


def stream_record(mod, name, replaces, streams, originals, err, label):
    """The stream kernel's record on its path's own inputs: streams that
    each decode to their original within the caps, so every input and
    output byte is needed. `err` is the check set's max abs err."""
    err2, ms, plain_ms, _ = stream_kernel_vs_plain(
        mod, name, list(zip(streams, originals)), label)
    # bytes the kernel must move: each stream byte and length read once,
    # each decoded byte and the trailer words (inflate_v2: flags and
    # count; inflate_static: count) written once
    trailer = 8 if name == "inflate_v2" else 4
    nbytes = sum(len(z) + 4 + trailer for z in streams) \
        + sum(map(len, originals))
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
    """inflate_v2 against its plain version at its 64 KiB caps; then the
    kernel alone on the 256 zlib-6 slices, and beside pass 1 on the
    small path's 7 slices. Returns its JSON record."""
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
    big = data[:SLICE + 8192]
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
    originals = small_batch_slices(data)
    seven = [raw_z(c) for c in originals]
    rec = stream_record(v2, "inflate_v2", "ops/pallas/inflate_v2.py:60",
                        seven, originals, err,
                        f"the small-batch path's {len(seven)} slices")
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
    cases += [(fixed_z(c)[:20000], MUTATED), (raw_z(c, 0)[:30000], None)]
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    card = phase_card()
    phase_build()
    data = corpus()
    rec = phase_kernel(data)

    it.LAUNCHES = 0                       # the main path starts here
    items, comp = phase_compress(data)
    counts = route_counts()
    phase_decompress("L6 items", comp, items, [ITEM] * len(comp))
    counts = route_counts(counts)
    chunks = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    slices = [raw_z(c) for c in chunks]
    counts_sl = route_counts()
    phase_decompress("zlib-6 slices", slices, chunks, [SLICE] * N_SLICES)
    counts_sl = route_counts(counts_sl)
    rec["launches"] = it.LAUNCHES
    assert rec["launches"] > 0, "the main path never launched pass 1"
    log(f"pass-1 kernel launches on the main path: {rec['launches']}")
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
    assert "jax" not in sys.modules, "the port imported jax"
    assert not any(m.split(".")[0] == "libdeflate_rsx_tpu"
                   for m in sys.modules), "the port imported the JAX package"

    log(card)
    print(json.dumps({"kernels": [rec, rec_v2, rec_st]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
