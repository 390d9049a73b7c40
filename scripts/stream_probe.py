#!/usr/bin/env python3
"""Time the PyTorch port's two stream kernels alone on one CUDA card.

Usage: python3 scripts/stream_probe.py [--versus CSRC_DIR ...]
       (from the root of a checkout; about two minutes)

Builds the kernels, makes the Silesia-like corpus as `chip_smoke.py`
does, and times by CUDA events each call as its wrapper makes it (output
allocation and launch): inflate_v2 on batches of 1 and 7 zlib-6 slices
of 64 KiB (the small-batch path's inputs) and on 256 zlib-6 slices, and
inflate_static on the static path's 128 Z_FIXED slices, with each
set's byte bound and the token mix of its longest stream (by the
pass-1 kernel); and inflate_v2 on the first slice coded with
Z_HUFFMAN_ONLY (literals only), which separates a literal's cost from a
match's. Every stream that fits the input cap must decode to
its slice.

With --versus, the kernels of other `csrc` directories (a `git archive`
of the parent commit, say, or a variant) are compiled beside them into
`build/versus/<k>/`, held equal to this tree's kernels word for word on
the same inputs, and timed in turns with them (each versus, tree, tree,
each versus in reverse); their caller zero-fills the output, as the
parent's wrapper did. It is the quick measurement of a stream-kernel
change; `chip_smoke.py` holds the kernels to their plain versions.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

NAMES = ("inflate_v2", "inflate_static")


def build_versus(dirs: list[str]) -> list[dict]:
    """For each csrc directory, the C entry points of its <name>.cu for
    NAMES, compiled with the tree's flags into build/versus/<k>/: one
    nvcc each, all started together."""
    from libdeflate_rsx_tpu_torch.ops import _build
    jobs = []
    for k, csrc in enumerate(dirs):
        out = os.path.join(ROOT, "build", "versus", str(k))
        os.makedirs(out, exist_ok=True)
        for n in NAMES:
            so = os.path.join(out, n + ".so")
            jobs.append((k, n, so, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so,
                 os.path.join(csrc, n + ".cu")], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
    fns = [{"label": f"versus {k} ({d})"} for k, d in enumerate(dirs)]
    for k, n, so, p in jobs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{err}")
        fn = getattr(ctypes.CDLL(so), "ldrsx_" + n)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k][n] = fn
    return fns


def versus_call(fn, lens, words):
    import torch
    from libdeflate_rsx_tpu_torch.ops.inflate_v2 import OUT_WORDS
    out = torch.zeros((lens.shape[0], OUT_WORDS), dtype=torch.int32,
                      device=words.device)
    rc = fn(lens.data_ptr(), words.data_ptr(), lens.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"versus kernel launch failed: CUDA error {rc}")
    return out


def token_mix(streams) -> str:
    """Literal and match tokens of the stream with the most tokens (the
    one that sets a launch's time), from the pass-1 kernel."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
    args = it.pack_streams(streams, it.in_cap_bucket(streams), "cuda")[:3]
    tok, st = it.pass1(*args, cs.SLICE)
    i = int(st[:, 3].argmax())
    kind = tok[i, :int(st[i, 3])] >> 29
    return (f"longest stream {int((kind == 1).sum())} literals, "
            f"{int((kind == 2).sum())} matches")


def probe_set(mod, name, label, streams, originals, versus):
    """One input set: the tree's kernel and each versus kernel timed in
    turns, the outputs checked against the slices and each other."""
    import torch
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2
    lens, words = v2.pack(streams, "cuda")
    kernel = getattr(mod, name)
    out = kernel(lens, words)
    torch.cuda.synchronize()
    rows = out.cpu().numpy()
    for i, (z, want) in enumerate(zip(streams, originals)):
        if len(z) <= v2.IN_CAP:
            n = int(rows[i, -1])
            assert rows[i].view("<u1")[:max(n, 0)].tobytes() == want, \
                f"{name} on {label}: stream {i} (count {n})"
    nbytes = cs.stream_bytes(name, [z for z in streams if len(z) <= v2.IN_CAP],
                             [w for z, w in zip(streams, originals)
                              if len(z) <= v2.IN_CAP])
    bound = f"bound {nbytes / cs.HBM_BYTES_PER_MS:.6f} ms ({nbytes} bytes)"
    runs = {"tree": lambda: kernel(lens, words)}
    for v in versus:
        other = versus_call(v[name], lens, words)
        torch.cuda.synchronize()
        assert torch.equal(out, other), f"{name} on {label}: tree != {v['label']}"
        runs[v["label"]] = (lambda fn: lambda: versus_call(fn, lens, words))(
            v[name])
    others = [k for k in runs if k != "tree"]
    t = {k: [] for k in runs}
    for k in others + ["tree", "tree"] + others[::-1]:
        t[k].append(cs.time_cuda(runs[k], cs.KERNEL_REPS))
    times = "; ".join(f"{k} " + " / ".join(f"{x:.3f}" for x in v)
                      for k, v in t.items())
    fit = [z for z in streams if len(z) <= v2.IN_CAP]
    cs.log(f"{name} on {label}: {times} ms per call (CUDA events, "
           f"{cs.KERNEL_REPS} calls each, in turns)"
           f"{'; equal' if versus else ''}; {bound}; {token_mix(fit)}")


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--versus", nargs="*", default=[],
                    help="other csrc directories to time against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_probe: no CUDA device", file=sys.stderr)
        return 1
    from libdeflate_rsx_tpu_torch.ops import inflate_static as st
    from libdeflate_rsx_tpu_torch.ops import inflate_v2 as v2

    card = cs.phase_card()
    cs.phase_build()
    versus = build_versus(args.versus)
    data = cs.corpus()
    small = cs.small_batch_slices(data)
    chunks = [data[i * cs.SLICE:(i + 1) * cs.SLICE] for i in range(cs.N_SLICES)]
    fixed, fixed_z = cs.static_slices(data)
    sets = [(v2, "inflate_v2", f"a batch of {n} zlib-6 slice(s)",
             [cs.raw_z(c) for c in small[:n]], small[:n]) for n in cs.N_SMALL]
    sets.append((v2, "inflate_v2", f"{cs.N_SLICES} zlib-6 slices",
                 [cs.raw_z(c) for c in chunks], chunks))
    # literals only: the first slice Huffman-coded without matches
    huff = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_HUFFMAN_ONLY)
    sets.append((v2, "inflate_v2", "a batch of 1 Z_HUFFMAN_ONLY slice "
                 "(65,536 literals)", [huff.compress(small[0]) + huff.flush()],
                 small[:1]))
    sets.append((st, "inflate_static", f"{cs.N_STATIC} Z_FIXED slices",
                 fixed_z, fixed))
    for mod, name, label, streams, originals in sets:
        probe_set(mod, name, label, streams, originals, versus)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
