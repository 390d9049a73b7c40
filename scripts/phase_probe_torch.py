#!/usr/bin/env python3
"""Phase breakdown of the PyTorch port's main path on one CUDA card.

Usage: python3 scripts/phase_probe_torch.py [--out FILE]
           [--analyze-only | --compress-only]

Times, with the card synchronised around each phase: BatchCompressor
cold and warm; the encode phases of a BatchCompressor run at levels 6
and 4 (split, host-to-device, analyze, table step, emit, assembly with
the stored fallback and join, device-to-host copy of the joined
streams, the items' join on the host) and at level 1 (split,
host-to-device, encode, assembly, device-to-host; summed over the
items), read at the flows' own phase ends: since the table step and the
assembly run on the card (ops/dyn_tables.py, ops/assemble.py), every
phase but split, d2h and join is device work; the
pass-1 kernel, and the resolve kernel beside its plain version on the
card, at the main path's shapes (CUDA events); the plain pass 1 on the 256-slice decode set (host clock);
BatchDecompressor on both decode sets; and the device busy share of one
decompress and one compress from torch.profiler. First, the L6 analyze
step split into its parts on the L6 pass's 259 windows (CUDA events, each
part alone): the match finder (the kernel, and its plain version on the
card) and the select kernel (ops/select.py: run extension, lazy
demotion, selection and the histograms), and analyze_block_l6 whole
with each finder; beside them the select kernel's plain version whole
and in its three parts (extend_runs, select_tokens_l6, the histograms);
with --analyze-only, only that. With --compress-only, only the
compress: the level-6 walls and phases, the level-1 and level-4 warm
walls and phases, and the compress's busy share, so that two trees'
copies of this script can be run in turns in one call to the card.
Each line is printed,
and copied to FILE when given. Needs one CUDA card; the corpus and the
card and build phases are chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 65536


def sync():
    import torch
    torch.cuda.synchronize()


def lap(t0: float) -> tuple[float, float]:
    """(milliseconds since t0 after a device sync, now)."""
    sync()
    now = time.perf_counter()
    return 1e3 * (now - t0), now


def encode_phases(bc, items, say):
    """Phase times of one BatchCompressor run, taken where the encode
    flow ends each phase (models/greedy_static.PHASE_END), with the card
    synchronised there: the phases of the path itself, serialised, each
    summed over its repeats (the level-1 tier runs per item)."""
    from libdeflate_rsx_tpu_torch.models import greedy_static as g

    ms = {}
    last = [0.0]

    def end(name):
        dt, last[0] = lap(last[0])
        ms[name] = ms.get(name, 0.0) + dt

    sync()
    g.PHASE_END = end
    try:
        t0 = last[0] = time.perf_counter()
        bc.compress_batch(items)
        total = lap(t0)[0]
    finally:
        g.PHASE_END = None
    blocks = sum(max(1, -(-len(d) // BLOCK)) for d in items)
    say(f"compress L{bc.level} phases ({blocks} blocks, total {total:.1f}): "
        + " ".join(f"{k} {v:.1f}" for k, v in ms.items()) + " ms")


def analyze_split(items, say, reps: int = 5):
    """Device ms of analyze_block_l6 and of each of its parts on the L6
    pass's windows of the items, each part alone on its own inputs (CUDA
    events, the mean of reps calls): first with the match finder's plain
    version on the card, then with its kernel; the select kernel in both,
    and its plain version whole and in its parts beside it."""
    import torch

    import chip_smoke as cs
    from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ed
    from libdeflate_rsx_tpu_torch.ops import match_l6 as ml6
    from libdeflate_rsx_tpu_torch.ops import select as sl
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import extend_runs

    rows, valid, hist, s = cs.l6_windows_of(items, BLOCK)
    valid = valid.long()
    kernel = ml6.find_matches_l6
    for name, finder in (("plain", ed.find_matches_l6_plain),
                         ("kernel", kernel)):
        ms = {"find_matches_l6": cs.time_cuda(
            lambda: finder(rows, valid, hist, s), reps)}
        ml, dist = finder(rows, valid, hist, s)
        ms["select"] = cs.time_cuda(
            lambda: sl.select(ml, dist, valid, rows, l6=True), reps)
        plain = {"select_plain": cs.time_cuda(
            lambda: sl.select_plain(ml, dist, valid, rows, l6=True), reps)}
        plain["extend_runs"] = cs.time_cuda(
            lambda: extend_runs(ml, dist, valid), reps)
        ext = extend_runs(ml, dist, valid)
        plain["select_tokens_l6"] = cs.time_cuda(
            lambda: ed.select_tokens_l6(ext, dist, valid), reps)
        sel_ml, sel, lit = (x[:, ed.HIST:] for x in
                            ed.select_tokens_l6(ext, dist, valid))
        pay = dist[:, ed.HIST:]
        byte = rows[:, ed.HIST:s].to(torch.int64)
        plain["histograms"] = cs.time_cuda(
            lambda: ed._histograms(byte, sel_ml, pay, sel, lit), reps)
        ml6.find_matches_l6 = finder      # analyze_block_l6 takes it
        try:
            whole = cs.time_cuda(
                lambda: ed.analyze_block_l6(rows, valid, hist, BLOCK), reps)
        finally:
            ml6.find_matches_l6 = kernel
        say(f"analyze split, {name} match finder ({rows.shape[0]} windows "
            f"of {s} positions; CUDA events, {reps} calls each): "
            + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
            + f" (sum {sum(ms.values()):.3f}); analyze_block_l6 {whole:.3f} "
              f"ms; beside them the select kernel's plain version: "
            + " ".join(f"{k} {v:.3f}" for k, v in plain.items()) + " ms")


def busy_share(name, fn, say):
    """Device busy share of fn(): the self time of the records on the
    device's timeline (kernels, copies, sets) over the wall time. The
    operator rows that carry their kernels' time are host records and
    are not counted again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    say(f"profile {name}: wall {wall * 1e3:.1f} ms, device time "
        f"{dev_us / 1e3:.1f} ms, busy share {dev_us / 1e6 / wall:.3f}")
    say(ka.table(sort_by="self_device_time_total", row_limit=12,
                 max_name_column_width=50))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every line to this file")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--analyze-only", action="store_true",
                      help="only the L6 analyze split")
    mode.add_argument("--compress-only", action="store_true",
                      help="only the compress walls, phases and busy share")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say, args.analyze_only, args.compress_only)


def probe(say, analyze_only: bool = False,
          compress_only: bool = False) -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    from libdeflate_rsx_tpu_torch.ops.resolve import (resolve_batch,
                                                       resolve_batch_plain)

    if not torch.cuda.is_available():
        print("phase_probe_torch: no CUDA device", file=sys.stderr)
        return 1
    cs.phase_card()
    cs.phase_build()
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    if not compress_only:
        analyze_split(items, say)
    if analyze_only:
        return 0

    bc = BatchCompressor(level=6, use_device=True, device="cuda")
    for label in ("cold", "warm", "warm"):
        t0 = time.perf_counter()
        comp = bc.compress_batch(items)
        say(f"compress_batch {label} {lap(t0)[0]:.1f} ms")
    for _ in range(2):
        encode_phases(bc, items, say)
    for level in (1, 4):
        tier = BatchCompressor(level=level, use_device=True, device="cuda")
        tier.compress_batch(items)                       # warm
        for _ in range(2):
            t0 = time.perf_counter()
            tier.compress_batch(items)
            say(f"compress_batch L{level} warm {lap(t0)[0]:.1f} ms")
        for _ in range(2):
            encode_phases(tier, items, say)
    if compress_only:
        busy_share("compress", lambda: bc.compress_batch(items), say)
        return 0

    chunks = [data[i * BLOCK:(i + 1) * BLOCK] for i in range(cs.N_SLICES)]
    streams = [cs.raw_z(c) for c in chunks]
    a256 = it.pack_streams(streams, BLOCK, "cuda")[:3]
    a17 = it.pack_streams(comp, cs.ITEM, "cuda")[:3]
    ms256 = cs.time_cuda(lambda: it.pass1(*a256, BLOCK), 5)
    ms17 = cs.time_cuda(lambda: it.pass1(*a17, cs.ITEM), 5)
    tok256, st256 = it.pass1(*a256, BLOCK)
    tok17, st17 = it.pass1(*a17, cs.ITEM)
    say(f"kernel 256x64KiB {ms256:.3f} ms; kernel 17x1MiB {ms17:.3f} ms "
        f"(max tokens {int(st17[:, 3].max())})")
    n256, n17 = int(st256[:, 3].max()), int(st17[:, 3].max())
    r256 = cs.time_cuda(lambda: resolve_batch(tok256[:, :n256], BLOCK), 5)
    r17 = cs.time_cuda(lambda: resolve_batch(tok17[:, :n17], cs.ITEM), 5)
    p256 = cs.time_cuda(lambda: resolve_batch_plain(tok256[:, :n256], BLOCK),
                        5)
    p17 = cs.time_cuda(lambda: resolve_batch_plain(tok17[:, :n17], cs.ITEM),
                       5)
    say(f"resolve kernel 256x64KiB {r256:.3f} ms, 17x1MiB {r17:.3f} ms; "
        f"plain version on the card 256x64KiB {p256:.3f} ms, 17x1MiB "
        f"{p17:.3f} ms")
    t0 = time.perf_counter()
    tp, sp = it.pass1_plain(*a256, BLOCK)
    plain = lap(t0)[0]
    assert torch.equal(tp, tok256) and torch.equal(sp, st256)
    say(f"plain 256x64KiB {plain:.1f} ms (equal to the kernel)")

    sets = (("zlib-6 slices", streams, chunks, [BLOCK] * len(streams)),
            ("L6 items", comp, items, [cs.ITEM] * len(comp)))
    for name, ss, orig, caps in sets:
        bd = BatchDecompressor(use_device=True, resolve="device",
                               device="cuda")
        for rep in range(3):
            t0 = time.perf_counter()
            got = bd.decompress_batch(ss, caps)
            say(f"decompress {name} rep{rep} {lap(t0)[0]:.1f} ms")
        assert got == orig and not bd.fallbacks

    bd = BatchDecompressor(use_device=True, resolve="device", device="cuda")
    busy_share("decompress zlib-6 slices",
               lambda: bd.decompress_batch(streams, [BLOCK] * len(streams)),
               say)
    busy_share("compress", lambda: bc.compress_batch(items), say)
    return 0


if __name__ == "__main__":
    sys.exit(main())
