"""LZ copy resolution: the port's resolve_batch_plain (what resolve_batch
runs on a CPU tensor) against the JAX package's resolve_batch_jax and the
numpy oracle resolve_tokens_np, and a Python mirror of the CUDA kernel
(csrc/resolve.cu) against the plain version.

Cases: those of tests/test_resolve_device.py (literals, overlapping
copies, NOPs, per-offset periodic chains, deep chains, seeded random
columns, a match before the start and output past out_cap), and the
edge columns of tests/_port_corpus.py: a 1 MiB dist-1 run, periodic
chains at distances 2..33, distance 32,768 across windows, matches
before the start in a later window, sums at and just past out_cap,
NOP and kind-3 tokens anywhere, T == 0 and B == 0. The JAX graph emits
nothing for kind 3, as for a NOP; resolve_tokens_np rejects it, so the
oracle reads each column with its kind-3 tokens taken out.

Tolerance: exact (outlen, ok, and the bytes [0, outlen) of ok rows).
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 24)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _port_corpus as pc
from libdeflate_rsx_tpu.ops.resolve import resolve_batch_jax
from libdeflate_rsx_tpu.ops.tokens import KIND_SHIFT, resolve_tokens_np
from libdeflate_rsx_tpu_torch.ops import resolve as rs
from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch

torch.set_num_threads(2)
assert pc.KIND_SHIFT == KIND_SHIFT


def check(cols, out_cap):
    """Port == JAX == numpy oracle on every stream of the batch."""
    toks = np.stack(cols)
    out, outlen, ok = resolve_batch(torch.from_numpy(toks), out_cap)
    jout, jlen, jok = jax.jit(lambda t: resolve_batch_jax(t, out_cap))(
        jnp.asarray(toks))
    assert out.dtype == torch.uint8 and out.shape == (len(cols), out_cap)
    assert np.array_equal(outlen.numpy(), np.asarray(jlen))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    got = []
    for i, c in enumerate(cols):
        n = int(outlen[i])
        mine = out[i, :n].numpy().tobytes() if bool(ok[i]) else None
        assert mine == (np.asarray(jout)[i, :n].tobytes()
                        if bool(jok[i]) else None)
        assert mine == resolve_tokens_np(c[(c >> KIND_SHIFT) & 3 != 3],
                                         out_cap)
        got.append(mine)
    return got


def test_literals_and_overlaps():
    got = check(*pc.overlap_columns())
    assert got[0] == bytes(range(40))


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 7, 8, 18, 31, 32, 64])
def test_per_offset_patterns(dist):
    (got,) = check(*pc.offset_columns(dist))
    assert got[dist:2 * dist] == got[:dist]


def test_deep_chain_through_mixed_tokens():
    check(*pc.deep_chain_columns())


def test_bad_cases():
    got = check(*pc.bad_columns())
    assert got[1] is None and got[2] is None
    assert len(got[3]) == 16


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_seeded_random_columns(seed):
    check(*pc.random_columns(seed))


EDGE = ["dist-1 run of 1 MiB", "periodic d 2..33", "d 32768 across windows",
        "before the start", "past out_cap", "NOP and kind 3",
        "random kind 3 seed 30"]


@pytest.mark.parametrize("name", EDGE)
def test_edge_columns(name):
    cols, cap = pc.RESOLVE_CASES[name]()
    got = check(cols, cap)
    if name == "dist-1 run of 1 MiB":
        assert got == [b"\x5a" * cap]
    if name == "before the start":
        assert [g is None for g in got] == [True, True, False, True]
    if name == "past out_cap":
        assert [g is None for g in got] == [False, True, True, True]
    if name == "NOP and kind 3":
        assert all(g is not None for g in got)


def test_a_4000_match_dist1_chain_at_a_1mib_cap():
    cols, cap = pc.dist1_run_columns()
    assert cap == 1 << 20 and (cols[0] >> KIND_SHIFT == 2).sum() >= 4000
    (got,) = check(cols, cap)
    assert len(got) == cap


def test_empty_shapes():
    """T == 0 (the plain version pads a NOP column; the JAX graph
    cannot index an empty axis, so it gets that column) and B == 0."""
    out, outlen, ok = resolve_batch(torch.zeros((3, 0), dtype=torch.int32),
                                    16)
    pad = np.zeros((3, 1), np.int32)
    jout, jlen, jok = resolve_batch_jax(jnp.asarray(pad), 16)
    assert out.shape == (3, 16) and outlen.tolist() == [0, 0, 0]
    assert np.array_equal(outlen.numpy(), np.asarray(jlen))
    assert np.array_equal(ok.numpy(), np.asarray(jok)) and bool(ok.all())
    assert resolve_tokens_np(np.zeros(0, np.int32), 16) == b""
    for T in (0, 5):
        out, outlen, ok = resolve_batch(
            torch.zeros((0, T), dtype=torch.int32), 16)
        assert out.shape == (0, 16) and outlen.shape == ok.shape == (0,)
    jout, jlen, jok = resolve_batch_jax(jnp.zeros((0, 5), jnp.int32), 16)
    assert np.asarray(jout).shape == (0, 16)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    toks = torch.from_numpy(np.stack(pc.bad_columns()[0]))
    before = rs.LAUNCHES
    got = resolve_batch(toks, 16)
    assert rs.LAUNCHES == before
    want = rs.resolve_batch_plain(toks, 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        resolve_batch(toks[0], 16)
    with pytest.raises(ValueError):
        resolve_batch(toks, -1)


# ------------------------------------------------- the kernel's mirror
WIN = 4096                       # csrc/resolve.cu WIN
SOLO = 32                        # csrc/resolve.cu SOLO
MAX_BACK = 257 + 32768           # csrc/resolve.cu MAX_BACK
RING = 65536                     # csrc/resolve.cu RING


def mirror(toks: np.ndarray, out_cap: int, window: int, tile: int = 64):
    """csrc/resolve.cu step for step, in Python, with windows of `window`
    bytes and scan tiles of `tile` tokens: (out (B, out_cap) uint8,
    outlen (B,), ok (B,)); the rows that are not ok stay zero. The lanes of a warp are a loop whose reads all
    come before its writes, as in one step on the card; the windows run
    in reverse order, since none reads another."""
    assert window + MAX_BACK <= RING
    B, T = toks.shape
    nwin = -(-out_cap // window)
    out = np.zeros((B, out_cap), np.uint8)
    outlen = np.zeros(B, np.int32)
    ok = np.zeros(B, bool)
    for b in range(B):
        row = [int(x) for x in toks[b]]
        kind = [(x >> KIND_SHIFT) & 3 for x in row]
        ext = [(x & 0xFF) + 3 if k == 2 else int(k == 1)
               for x, k in zip(row, kind)]
        dist = [((x >> 8) & 0x7FFF) + 1 for x in row]
        # tile_sums_kernel, scan_kernel (tiles in reverse order: none
        # reads another's output), verdict_kernel
        sums = [sum(ext[k:k + tile]) for k in range(0, T, tile)]
        bad, first = [False] * len(sums), {}
        for k in reversed(range(len(sums))):
            carry = sum(sums[:k])
            for i in range(k * tile, min(k * tile + tile, T)):
                bad[k] |= kind[i] == 2 and carry < dist[i]
                # the windows whose first byte this token covers: at most
                # one for windows of 258 bytes or more, as on the card
                w = -(-carry // window)
                while w < nwin and w * window < carry + ext[i]:
                    first[w] = (i, carry)
                    w += 1
                carry += ext[i]
        n = outlen[b] = min(sum(sums), out_cap)
        ok[b] = sum(sums) <= out_cap and not any(bad)
        if not ok[b]:
            continue
        # window_kernel
        vals = [None] * (nwin * window)
        for w in reversed(range(nwin)):
            ws = w * window
            if ws >= n:
                continue
            wlen = min(n - ws, window)
            buf = [None] * window
            t, base = first[w]
            base -= ws
            assert -257 <= base <= 0
            while base < wlen and t < T:
                grp = range(t, min(t + 32, T))
                starts = list(itertools.accumulate(
                    (ext[i] for i in grp), initial=base))
                for j, i in enumerate(grp):
                    if kind[i] == 1 and 0 <= starts[j] < wlen:
                        buf[starts[j]] = row[i] & 0xFF
                copies = [j for j, i in enumerate(grp) if kind[i] == 2
                          and starts[j] < wlen and starts[j] + ext[i] > 0]
                # a short match whose source ends before the group's
                # first byte: its lane alone, beside the other lanes
                solo = [j for j in copies if ext[grp[j]] <= SOLO
                        and starts[j] - dist[grp[j]]
                        + min(ext[grp[j]], dist[grp[j]]) <= base]
                for j in solo:
                    s, e, d = starts[j], ext[grp[j]], dist[grp[j]]
                    for p in range(max(s, 0), min(s + e, wlen)):
                        q = s - d + (p - s) % d
                        assert q < base
                        buf[p] = buf[q] if q >= 0 else 255 - q
                        assert buf[p] is not None
                for j in copies:
                    s, e, d = starts[j], ext[grp[j]], dist[grp[j]]
                    if j in solo:
                        continue
                    ps = range(max(s, 0), min(s + e, wlen))
                    for c in range(0, len(ps), 32):
                        step, got = ps[c:c + 32], []
                        for p in step:
                            off = p - s
                            if off >= d:
                                off %= d
                            q = s - d + off
                            assert q < s
                            got.append(buf[q] if q >= 0 else 255 - q)
                            assert got[-1] is not None
                        for p, v in zip(step, got):
                            buf[p] = v
                base = starts[-1]
                t += 32
            assert None not in buf[:wlen]
            assert max(buf[:wlen]) <= 255 + MAX_BACK
            vals[ws:ws + wlen] = buf[:wlen]
        # finish_kernel: windows in order, each one parallel gather from a
        # ring of the last RING final bytes
        ring, held = [0] * RING, [-1] * RING
        for w in range(-(-n // window)):
            ws = w * window
            ps = range(ws, min(ws + window, n))
            src = [p if vals[p] < 256 else ws - (vals[p] - 255) for p in ps]
            assert all(held[q % RING] == q for q, p in zip(src, ps) if q != p)
            got = [vals[p] if q == p else ring[q % RING]
                   for q, p in zip(src, ps)]
            for p, v in zip(ps, got):
                ring[p % RING], held[p % RING] = v, p
            out[b, ws:ws + len(got)] = got
    return out, outlen, ok


def mirror_vs_plain(cols, out_cap, window):
    toks = np.stack(cols)
    out, outlen, ok = mirror(toks, out_cap, window)
    pout, plen, pok = rs.resolve_batch_plain(torch.from_numpy(toks), out_cap)
    assert np.array_equal(outlen, plen.numpy())
    assert np.array_equal(ok, pok.numpy())
    for i in np.flatnonzero(ok):
        n = outlen[i]
        assert np.array_equal(out[i, :n], pout[i, :n].numpy()), i
    return ok


@pytest.mark.parametrize("window", [16, 32, 64])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_mirror_equals_plain_on_seeded_columns(seed, window):
    """Windows of 16-64 bytes: every match's source lies windows back,
    so markers cross several windows."""
    cols, cap = pc.random_columns(seed, n=8, kind3=True)
    assert mirror_vs_plain(cols, cap, window).all()


@pytest.mark.parametrize("window", [64, WIN])
@pytest.mark.parametrize("name", ["dist-1 run of 1 MiB",
                                  "d 32768 across windows",
                                  "before the start", "past out_cap"])
def test_mirror_equals_plain_on_edge_columns(name, window):
    cols, cap = pc.RESOLVE_CASES[name]()
    mirror_vs_plain(cols, cap, window)


@pytest.mark.parametrize("window", [48, WIN])
def test_mirror_equals_plain_on_periodic_and_small_cases(window):
    """Periodic chains at distances 2..33 (every other one) and the
    small hand-built batches."""
    cols, cap = pc.periodic_columns(cap=8192)
    mirror_vs_plain(cols[::2], cap, window)
    for name in list(pc.RESOLVE_CASES)[:15]:
        mirror_vs_plain(*pc.RESOLVE_CASES[name](), window)
