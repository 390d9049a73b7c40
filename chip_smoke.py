#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Usage: python3 chip_smoke.py      (from the root of a checkout; one card)

Phases, in order; any failure raises and the script exits non-zero:

1. card: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: the pass-1 CUDA kernel, from csrc/ with nvcc (build/kernels/);
3. kernel against its plain PyTorch version, both on the card, at the
   64 KiB out_cap: zlib streams of every test-corpus kind and level,
   multi-block, garbage, truncated and bit-flipped streams, and 64 KiB
   slices of the Silesia-like corpus; tokens and stats must be equal;
4. compress: BatchCompressor(level=6, use_device=True) over the corpus
   in 1 MiB items, every output checked with zlib;
5. decompress: BatchDecompressor(use_device=True, resolve="device") on
   the compressed items and on 256 zlib-6 streams of 64 KiB slices,
   byte-exact with no host fallback;
6. the pass-1 kernel's launch count over phases 4-5 must be positive;
7. kernel against plain version again at the 1 MiB out_cap of the L6
   items (after the count is read), on a prefix of an L6 item of
   phase 4, a whole small L6 item, streams at the cap, and the small
   and bit-flipped cases of phase 3.

The last two lines are the kernels' JSON record and the result JSON. The
script exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
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
N_MUTATED = 96          # bit-flipped streams in the kernel-vs-plain set
L6_PREFIX = 28 << 10    # bytes of an L6 item in the 1 MiB kernel-vs-plain set
MUTATED = object()      # marks a case held only to the plain version
KERNEL_REPS = 5


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
    _build.load("inflate_tokens")
    dt = time.perf_counter() - t0
    log(f"build: inflate_tokens loaded in {dt:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS.get('inflate_tokens', 0.0):.2f} s)")
    report = _build.library_path("inflate_tokens") + ".log"
    if os.path.exists(report):
        for line in open(report).read().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
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
    the slice decode set; returns the kernel's JSON record."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    cases = small_cases()
    for i in range(N_CHECK_SLICES):
        c = data[i * SLICE:(i + 1) * SLICE]
        cases.append((raw_z(c), c))
    err, ms, plain_ms, stats = kernel_vs_plain(cases, SLICE, "64 KiB")
    n_mut = int((stats[-N_CHECK_SLICES - N_MUTATED:-N_CHECK_SLICES, 0]
                 == it.DONE).sum())
    log(f"kernel vs plain, out_cap 64 KiB: equal on {len(cases)} streams "
        f"({N_CHECK_SLICES} corpus slices of 64 KiB at zlib-6, "
        f"{N_MUTATED} bit-flipped streams of which {n_mut} DONE, "
        f"{len(cases) - N_CHECK_SLICES - N_MUTATED} small cases), "
        f"max abs err {err}")
    log(f"  pass-1 kernel {ms:.3f} ms per launch (CUDA events, "
        f"{KERNEL_REPS} launches); plain version {plain_ms:.1f} ms "
        f"(host clock, one run), on that same reduced set")
    return {"name": "inflate_tokens", "route": "cuda",
            "source": "libdeflate_rsx_tpu_torch/csrc/inflate_tokens.cu",
            "replaces": "libdeflate_rsx_tpu/ops/pallas/inflate_tokens.py:315",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    cases = [(comp[0][:L6_PREFIX], None), (two_c, two),
             (raw_z(zeros), zeros), (raw_z(zeros + b"\x00"), None)]
    cases += small_cases()
    err, ms, plain_ms, stats = kernel_vs_plain(cases, ITEM, "1 MiB")
    assert stats[3, 0] == it.BAD and stats[3, 1] > ITEM - 258, stats[3]
    log(f"kernel vs plain, out_cap 1 MiB: equal on {len(cases)} streams "
        f"(a {L6_PREFIX}-byte prefix of L6 item 0 decoding {stats[0, 1]} "
        f"bytes in {stats[0, 3]} tokens, a two-block L6 item, 1 MiB of "
        f"zeros and one byte more, {len(cases) - 4} small and bit-flipped "
        f"cases), max abs err {err}")
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    phase_card()
    phase_build()
    data = corpus()
    record = phase_kernel(data)

    it.LAUNCHES = 0                       # the main path starts here
    items, comp = phase_compress(data)
    phase_decompress("L6 items", comp, items, [ITEM] * len(comp))
    chunks = [data[i * SLICE:(i + 1) * SLICE] for i in range(N_SLICES)]
    phase_decompress("zlib-6 slices", [raw_z(c) for c in chunks], chunks,
                     [SLICE] * N_SLICES)
    launches = it.LAUNCHES
    assert launches > 0, "the main path never launched the pass-1 kernel"
    log(f"pass-1 kernel launches on the main path: {launches}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    record["max_abs_err"] = max(record["max_abs_err"],
                                phase_kernel_items(data, comp))
    assert "jax" not in sys.modules, "the port imported jax"

    record["launches"] = launches
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
