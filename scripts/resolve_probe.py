#!/usr/bin/env python3
"""Where the resolve kernel's time goes, on one CUDA card, and how it
compares with other designs of it.

Usage: python3 scripts/resolve_probe.py [--versus CSRC_DIR ...] [--out FILE]
       (from the root of a checkout; about two minutes)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and runs pass 1 on the main path's two decode sets (the 17 L6
items at the 1 MiB out_cap, the 256 zlib-6 slices at 64 KiB), whose
tokens go to resolve with pass 1's token counts, as the decoder passes
them. On those, and on four hand-built patterns of 256 columns of 64 KiB
each (all literals; a dist-1 run of 258-byte matches; matches of 8
bytes reaching 1,000-4,000 bytes back; matches of 8 bytes at distance
4, each reading the one before), it holds the kernel to its plain
version, times the call by CUDA events and splits it into its kernels'
device time with torch.profiler, beside the set's byte bound and the
share of its bytes that leave their 8 KiB window as markers (computed
from the tokens in plain PyTorch).

With --versus, the resolve kernel of other `csrc` directories (a `git
archive` of the parent commit, say: `git archive HEAD
libdeflate_rsx_tpu_torch/csrc | tar -x -C build/parent`) is compiled
with the tree's flags into `build/versus/<k>/`, called through its own
C entry point (an older one without token counts too), held equal to the
tree's kernel and timed in turns with it (each versus, tree, tree, each
versus in reverse), with its own kernels' split; the two-pass decode of
both main-path sets (BatchDecompressor, resolve on the card) is timed
the same way, host clock, with each resolve in its place. Every line
names the card and is copied to FILE when given.
"""

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402

REPS = 20
WALL_REPS = 5
WIN = 8192              # csrc/resolve.cu WIN
N_COLS = 256
CAP = 65536


def patterns():
    """{name: (columns, out_cap)}: the four hand-built patterns."""
    import numpy as np
    from _port_corpus import col, lit, match

    rng = np.random.default_rng(1)
    head = [lit(int(x)) for x in rng.integers(0, 256, 4096)]
    toks = {
        "literals": [lit(int(x)) for x in rng.integers(0, 256, CAP)],
        "dist-1 run": [lit(7)] + [match(258, 1)] * ((CAP - 1) // 258),
        "solo matches": head + [match(8, int(d)) for d in
                                rng.integers(1000, 4000, (CAP - 4096) // 8)],
        "chained matches": [lit(1), lit(2), lit(3), lit(4)]
        + [match(8, 4)] * ((CAP - 4) // 8),
    }
    return {k: ([col(t, len(t))] * N_COLS, CAP) for k, t in toks.items()}


def build_versus(dirs: list[str]) -> list[dict]:
    """For each csrc directory, its resolve.cu compiled with the tree's
    flags into build/versus/<k>/ (one nvcc each, all started together):
    [{"label", "fn": resolve_batch-like callable}]."""
    from libdeflate_rsx_tpu_torch.ops import _build
    jobs = []
    for k, csrc in enumerate(dirs):
        out = os.path.join(ROOT, "build", "versus", str(k))
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, "resolve.so")
        jobs.append((k, csrc, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, "resolve.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    found = []
    for k, csrc, so, p in jobs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{err}")
        with open(os.path.join(csrc, "resolve.cu")) as f:
            counted = "const void* counts" in f.read()
        found.append({"label": f"versus {k} ({csrc})",
                      "fn": versus_fn(ctypes.CDLL(so), counted)})
    return found


def versus_fn(lib, counted: bool):
    """resolve_batch through another build's C entry point: this tree's
    (tokens, ld, ntok, counts, nstreams, out_cap, scratch, out, pitch,
    outlen, ok, stream) when `counted`, else the older one without
    counts."""
    import torch
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ldrsx_resolve_scratch.argtypes = [i, i, q]
    lib.ldrsx_resolve_scratch.restype = q
    lib.ldrsx_resolve.argtypes = ([p, q, i, p] if counted else [p, q, i]) \
        + [i, q, p, p, q, p, p, p]
    lib.ldrsx_resolve.restype = i

    def call(tokens, out_cap, counts=None):
        b, t = tokens.shape
        dev = tokens.device
        out = torch.empty((b, out_cap), dtype=torch.uint8, device=dev)
        outlen = torch.empty(b, dtype=torch.int32, device=dev)
        ok = torch.empty(b, dtype=torch.bool, device=dev)
        scratch = torch.empty(lib.ldrsx_resolve_scratch(b, t, out_cap),
                              dtype=torch.uint8, device=dev)
        head = [tokens.data_ptr(), tokens.stride(0), t]
        if counted:
            head.append(None if counts is None else counts.data_ptr())
        rc = lib.ldrsx_resolve(*head, b, out_cap, scratch.data_ptr(),
                               out.data_ptr(), out_cap, outlen.data_ptr(),
                               ok.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"versus resolve failed: CUDA error {rc}")
        return out, outlen, ok
    return call


def marker_share(tok, stats, window: int = WIN) -> float:
    """Share of the output bytes whose chain of sources leaves their
    window of `window` bytes: the markers that the window kernel hands
    to the finish (plain PyTorch on the card, from the tokens)."""
    import torch
    kind = (tok >> 29) & 3
    ext = torch.where(kind == 2, (tok & 0xFF) + 3, (kind == 1).to(tok.dtype))
    idx = torch.arange(tok.shape[1], device=tok.device)
    ext = torch.where(idx < torch.from_numpy(stats[:, 3]).to(tok.device)
                      .reshape(-1, 1), ext, 0)
    marks = total = 0
    for b in range(tok.shape[0]):
        e = ext[b].long()
        n = int(e.sum())
        if n == 0:
            continue
        cov = torch.repeat_interleave(torch.arange(e.numel(), device=e.device),
                                      e)
        s = (torch.cumsum(e, 0) - e)[cov]
        d = ((tok[b].long() >> 8) & 0x7FFF)[cov] + 1
        p = torch.arange(n, device=e.device)
        off = p - s
        off = torch.where(off >= d, off % d, off)
        par = torch.where(kind[b][cov] == 2, s - d + off, p)
        # up each chain while it stays in the window (pointer doubling),
        # to a literal or to a source outside: a marker
        inside = par // window == p // window
        jump = torch.where(inside, par, p)
        for _ in range(window.bit_length() + 1):
            jump = jump[jump]
        marks += int((par[jump] != jump).sum())
        total += n
    return marks / max(total, 1)


def same(a, b, label: str) -> None:
    """Two resolve results equal: outlen, ok and the ok rows' bytes."""
    import torch
    out_a, len_a, ok_a = a
    out_b, len_b, ok_b = b
    assert torch.equal(len_a, len_b) and torch.equal(ok_a, ok_b), label
    for i in ok_a.nonzero().flatten().tolist():
        n = int(len_a[i])
        assert torch.equal(out_a[i, :n], out_b[i, :n]), f"{label}: row {i}"


def in_turns(runs: dict, timer) -> str:
    """Each other run, the tree twice, each other run in reverse."""
    others = [k for k in runs if k != "tree"]
    t = {k: [] for k in runs}
    for k in others + ["tree", "tree"] + others[::-1]:
        t[k].append(timer(runs[k]))
    return "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                     for k, v in t.items())


def decode_wall(streams, originals, cap):
    """Host-clock seconds of one two-pass decode, resolve on the card,
    mean of WALL_REPS after one warm-up; byte-exact, no fallback."""
    import torch
    from libdeflate_rsx_tpu_torch import BatchDecompressor
    bd = BatchDecompressor(use_device=True, resolve="device", device="cuda")

    def run():
        got = bd.decompress_batch(streams, [cap] * len(streams))
        assert got == originals and not bd.fallbacks
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WALL_REPS):
        run()
    return (time.perf_counter() - t0) / WALL_REPS


def probe(say, versus_dirs) -> int:
    import numpy as np
    import torch
    from libdeflate_rsx_tpu_torch import BatchCompressor
    from libdeflate_rsx_tpu_torch.ops import resolve as rs

    if not torch.cuda.is_available():
        print("resolve_probe: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_card()
    cs.phase_build()
    versus = build_versus(versus_dirs)
    tree = rs.resolve_batch
    data = cs.corpus()
    items = [data[i:i + cs.ITEM] for i in range(0, len(data), cs.ITEM)]
    comp = BatchCompressor(level=6, use_device=True,
                           device="cuda").compress_batch(items)
    chunks = [data[i * cs.SLICE:(i + 1) * cs.SLICE]
              for i in range(cs.N_SLICES)]
    slices = [cs.raw_z(c) for c in chunks]
    main = {"17 L6 items": (comp, items, cs.ITEM),
            "256 zlib-6 slices": (slices, chunks, cs.SLICE)}
    sets = {}
    for name, (streams, _, cap) in main.items():
        tok, stats = cs.pass1_columns(streams, cap)
        counts = torch.from_numpy(stats[:, 3].copy()).cuda()
        sets[name] = (tok, cap, counts, stats)
    for name, (cols, cap) in patterns().items():
        tok = torch.from_numpy(np.stack(cols)).cuda()
        counts = torch.full((tok.shape[0],), tok.shape[1], dtype=torch.int32,
                            device="cuda")
        stats = np.zeros((tok.shape[0], 4), np.int64)
        stats[:, 3] = tok.shape[1]
        sets[name] = (tok, cap, counts, stats)
    for name, (tok, cap, counts, stats) in sets.items():
        cs.resolve_vs_plain(tok, cap, name, counts)
        mine = tree(tok, cap, counts)
        runs = {"tree": lambda: tree(tok, cap, counts)}
        for v in versus:
            same(mine, v["fn"](tok, cap, counts),
                 f"{name}: tree != {v['label']}")
            runs[v["label"]] = (lambda fn: lambda: fn(tok, cap, counts))(
                v["fn"])
        times = in_turns(runs, lambda fn: cs.time_cuda(fn, REPS))
        plain = cs.time_cuda(lambda: rs.resolve_batch_plain(tok, cap), 3)
        nbytes = cs.resolve_bytes(stats, mine[1].cpu().numpy())
        say(f"resolve {name}: {tok.shape[0]} columns, "
            f"{int(stats[:, 3].sum())} tokens (max {int(stats[:, 3].max())} "
            f"a column), markers {marker_share(tok, stats):.3f} of the bytes "
            f"at {WIN}-byte windows; {times} ms per call (CUDA events, {REPS} calls "
            f"each, in turns); plain version {plain:.3f} ms; bound "
            f"{nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes) "
            f"[{card}]")
        for label, fn in runs.items():
            parts = cs.kernel_times(fn, REPS)
            say(f"  {label}: " + ", ".join(
                f"{k} {v:.1f} us" for k, v in sorted(parts.items()))
                + f"; sum {sum(parts.values()):.1f} us")
    if versus:
        for name, (streams, originals, cap) in main.items():
            runs = {"tree": tree}
            runs.update({v["label"]: v["fn"] for v in versus})

            def timer(fn):
                rs.resolve_batch = fn
                try:
                    return decode_wall(streams, originals, cap) * 1e3
                finally:
                    rs.resolve_batch = tree
            times = in_turns(runs, timer)
            say(f"two-pass decode of the {name}: {times} ms per batch "
                f"(host clock, mean of {WALL_REPS} after a warm-up, in "
                f"turns; byte-exact, no fallback) [{card}]")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time against")
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args()
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "w")) if args.out else None

        def say(msg: str) -> None:
            print(msg, flush=True)
            if out is not None:
                print(msg, file=out, flush=True)

        return probe(say, args.versus)


if __name__ == "__main__":
    sys.exit(main())
