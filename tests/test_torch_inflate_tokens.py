"""Pass 1 of the two-pass decoder: the port's plain PyTorch pass 1 (what
the CUDA kernel computes, run here on the CPU) against the JAX package's
Pallas kernel in interpret mode, and against zlib.

The JAX kernel runs once, in a module-scoped fixture: one call of
decode_tokens_device(streams, s=1, max_steps=2048), the suite's shared
pass-1 bucket (one interpret-mode compile in this worker).
Its raw outputs are taken from that same call and converted with
convert.from_jax_pass1. Tolerance: exact equality (integers, bytes).
"""

import random
import zlib

import numpy as np
import pytest
import torch

from _port_corpus import cut_stored_streams, mutated_streams
from libdeflate_rsx_tpu.ops.pallas import inflate_tokens as jitk
from libdeflate_rsx_tpu_torch import convert
from libdeflate_rsx_tpu_torch.batch import SMALL_BATCH, BatchDecompressor
from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it
from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch
from libdeflate_rsx_tpu_torch.ops.tokens import resolve_tokens_np
from tests.conftest import make_corpus

torch.set_num_threads(2)
MAX_STEPS = 2048


def _z(data, level=6):
    return zlib.compress(data, level)[2:-4]


def _streams():
    """(name, stream, original or None) — the corpora of
    tests/test_inflate_tokens.py."""
    cases = []
    for lvl in (0, 1, 6, 9):
        for kind in ("text", "random", "pattern"):
            d = make_corpus(kind, 350 + 37 * lvl, seed=lvl)
            cases.append((f"z{lvl}-{kind}", _z(d, lvl), d))
    d = make_corpus("text", 400, seed=3)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    multi = (co.compress(d[:200]) + co.flush(zlib.Z_FULL_FLUSH)
             + co.compress(d[200:]) + co.flush())
    cases += [("full-flush", multi, d), ("x", _z(b"x"), b"x"),
              ("empty", _z(b""), b"")]
    for off in (1, 2, 3, 4, 7):
        r = random.Random(off)
        base = bytes(r.randrange(256) for _ in range(off))
        d = (base * (600 // off + 1))[:600]
        cases.append((f"offset{off}", _z(d), d))
    cases.append(("zeros700", _z(b"\x00" * 700), b"\x00" * 700))
    r = random.Random(11)
    good = make_corpus("text", 300, seed=1)
    cases += [("garbage", bytes(r.randrange(256) for _ in range(60)), None),
              ("truncated", _z(good)[:25], None),
              ("btype3", b"\x07\x00", None),
              ("after-garbage", _z(good), good)]
    return cases


CASES = _streams()
NAMES = [c[0] for c in CASES]
# bit-flipped streams, held to the JAX kernel's verdicts only (zlib may
# judge some of them otherwise: the kernel accepts incomplete codes and
# ignores bytes after the final block); they ride the same JAX call. The
# JAX kernel's lanes stall on each other's block headers, so its steps
# grow with the batch: with 32 of them the call ends by step ~1250 of
# its 2048 (96 would push the full-flush stream past the budget)
MUTATED = mutated_streams(32)
STREAMS = [c[1] for c in CASES] + MUTATED


@pytest.fixture(scope="module")
def jax_pass1():
    """One JAX pass-1 call: decode_tokens_device's per-stream results and
    the raw kernel outputs it computed them from."""
    streams = STREAMS
    raw = {}
    real = jitk._jit_pass1

    def spy(*a, **k):
        run = real(*a, **k)

        def run_and_keep(*args):
            raw["out"] = run(*args)
            return raw["out"]
        return run_and_keep

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jitk, "_jit_pass1", spy)
        per_stream = jitk.decode_tokens_device(streams, s=1,
                                               max_steps=MAX_STEPS)
    toks, stats = (np.asarray(x) for x in raw["out"])
    return per_stream, convert.from_jax_pass1(toks, stats, len(streams), 1)


@pytest.fixture(scope="module")
def port_pass1():
    data, offs, lens, ok = it.pack_streams(STREAMS, 65536, "cpu")
    tokens, stats = it.pass1(data, offs, lens, jitk.OUT_CAP)
    return tokens.numpy(), stats.numpy(), ok


def test_decode_tokens_device_equals_jax(jax_pass1):
    """The per-stream wrapper: NOP-stripped columns and outlens equal the
    JAX wrapper's, None for the same streams."""
    per_stream, _ = jax_pass1
    mine = it.decode_tokens_device(STREAMS, jitk.OUT_CAP, device="cpu")
    for (col, n), (jcol, jn) in zip(mine, per_stream):
        assert (col is None) == (jcol is None) and n == jn
        if col is not None:
            assert np.array_equal(col, jcol[((jcol >> 29) & 3) != 0])


@pytest.mark.parametrize("name", NAMES)
def test_plain_pass1_equals_jax_kernel(name, jax_pass1, port_pass1):
    _check_stream(NAMES.index(name), jax_pass1, port_pass1)


def test_plain_pass1_equals_jax_kernel_on_bit_flipped_streams(jax_pass1,
                                                              port_pass1):
    for i in range(len(CASES), len(STREAMS)):
        _check_stream(i, jax_pass1, port_pass1)
    # the set reaches both verdicts
    modes = set(port_pass1[1][len(CASES):, 0].tolist())
    assert modes == {it.DONE, it.BAD}


def _check_stream(i, jax_pass1, port_pass1):
    per_stream, (jtoks, jstats, rows) = jax_pass1
    ptoks, pstats, ok = port_pass1
    assert tuple(rows[i]) == (0, i // 128, i % 128)
    # the JAX step budget must not decide any verdict here
    assert jstats[i, 0] in (it.DONE, it.BAD), "JAX step budget exhausted"
    assert (pstats[i, 0] == it.DONE) == (jstats[i, 0] == it.DONE)
    assert pstats[i, 0] == jstats[i, 0]
    assert pstats[i, 1] == jstats[i, 1]          # outlen
    assert pstats[i, 2] == jstats[i, 2]          # bits consumed
    n = int(jstats[i, 3])
    assert pstats[i, 3] == n
    assert np.array_equal(ptoks[i, :n], jtoks[i, :n])
    assert not ptoks[i, n:].any()
    col, outlen = per_stream[i]
    if jstats[i, 0] == it.DONE:
        stripped = col[((col >> 29) & 3) != 0]
        assert np.array_equal(stripped, ptoks[i, :n])
        assert outlen == pstats[i, 1]
    else:
        assert col is None


def test_verdicts_against_zlib(port_pass1):
    ptoks, pstats, ok = port_pass1
    out, outlen, rok = resolve_batch(torch.from_numpy(ptoks), jitk.OUT_CAP)
    for i, (name, _, want) in enumerate(CASES):
        done = pstats[i, 0] == it.DONE
        if want is None:
            assert not done, name
            continue
        assert done and bool(rok[i]), name
        assert out[i, :pstats[i, 1]].numpy().tobytes() == want, name


def test_from_jax_pass1_layout():
    """Two groups at s=1: stream i sits at (i // 128, 0, i % 128); NOPs
    are dropped and counted out of the stats."""
    g, nflush, s = 2, 1, 1
    toks = np.zeros((g, nflush, 256, s, 128), np.int32)
    stats = np.zeros((g, 8, s, 128), np.int32)
    lit = 1 << 29
    toks[1, 0, 3, 0, 2] = lit | 65          # stream 130
    toks[1, 0, 9, 0, 2] = lit | 66
    toks[0, 0, 0, 0, 0] = (2 << 29) | 5     # stream 0: one match
    stats[1, 0, 0, 2], stats[1, 1, 0, 2], stats[1, 3, 0, 2] = 6, 2, 77
    out, st, rows = convert.from_jax_pass1(toks, stats, 131, s)
    assert out.shape == (131, 2)
    assert out[130].tolist() == [lit | 65, lit | 66]
    assert out[0].tolist() == [(2 << 29) | 5, 0]
    assert st[130].tolist() == [6, 2, 77, 2]
    assert tuple(rows[130]) == (1, 0, 2)


@pytest.mark.parametrize("wrapper", ["inflate_device_fused",
                                     "inflate_device_tokens"])
def test_plain_pass1_and_resolve_equal_zlib_on_64k_slices(wrapper):
    """No JAX: 64 KiB slices of every make_corpus kind through the plain
    pass 1 and pass 2 on the device (resolve_batch) or on the host."""
    kinds = ("text", "random", "pattern", "zeros", "periodic:7")
    datas = [make_corpus(k, 65536, seed=5) for k in kinds]
    got = getattr(it, wrapper)([_z(d) for d in datas], out_cap=65536,
                               device="cpu")
    assert got == datas


def test_stream_over_caps_and_out_cap():
    """An over-in-cap stream never decodes; a stream whose output passes
    out_cap is BAD with its output stopped at the cap."""
    d = make_corpus("text", 3000, seed=2)
    got = it.inflate_device_fused([_z(d), b"\x01" * 70000], out_cap=2048,
                                  in_cap=65536, device="cpu")
    assert got == [None, None]
    data, offs, lens, ok = it.pack_streams([_z(d)], 65536, "cpu")
    _, stats = it.pass1(data, offs, lens, 2048)
    assert stats[0, 0] == it.BAD and stats[0, 1] <= 2048


# ------------------------------------------- final stored blocks cut short
# Streams whose final stored block is cut by one byte: the port rejects
# them (pass 1 BAD, the host decoder then fails too, as zlib does); the
# JAX kernel accepts them with the missing byte read as 0.
CUT = cut_stored_streams()


def test_cut_stored_set_is_what_it_says():
    assert len(CUT) >= SMALL_BATCH
    for z, d in CUT:
        o = zlib.decompressobj(-15)
        assert o.decompress(z) == d[:-1] and not o.eof
        assert zlib.decompress(z + d[-1:], -15) == d


@pytest.mark.parametrize("route", ["segments", "serial", "plain"])
def test_plain_pass1_rejects_cut_stored_streams(route):
    """Every cut stream is BAD on each route of the plain pass 1, in one
    batch with their uncut forms, which still decode to the originals."""
    cut = [z for z, _ in CUT]
    whole = [z + d[-1:] for z, d in CUT]
    data, offs, lens, _ = it.pack_streams(cut + whole, 65536, "cpu")
    if route == "plain":
        tokens, stats = it.pass1_plain(data, offs, lens, 65536)
    else:
        tokens, stats = it.pass1(data, offs, lens, 65536,
                                 _sync_stops=route == "segments")
    n = len(CUT)
    assert stats[:n, 0].tolist() == [it.BAD] * n
    assert stats[n:, 0].tolist() == [it.DONE] * n
    out, outlen, ok = resolve_batch(tokens[n:], 65536)
    for i, (_, d) in enumerate(CUT):
        assert bool(ok[i]) and out[i, :outlen[i]].numpy().tobytes() == d


@pytest.mark.parametrize("resolve", ["device", "host"])
def test_batch_gives_none_for_cut_stored_streams(resolve):
    """On the two-pass route each cut stream gives None and counts a
    pass-1 fallback; its uncut form, in the same batch, decodes."""
    cut = [z for z, _ in CUT]
    whole = [z + d[-1:] for z, d in CUT]
    caps = [len(d) for _, d in CUT] * 2
    bd = BatchDecompressor(use_device=True, resolve=resolve, device="cpu")
    got = bd.decompress_batch(cut + whole, caps)
    assert got == [None] * len(CUT) + [d for _, d in CUT]
    assert dict(bd.fallbacks) == {"pass1": len(CUT)}


def test_jax_kernel_accepts_cut_stored_streams():
    """The JAX package's verdict differs on purpose: its pass 1 (the
    suite's shared bucket, s=1 and 2048 steps) ends the final stored
    block before its overrun check, so it decodes each cut stream to its
    original length with the last byte read as 0. The port gives None
    for the same streams."""
    got = jitk.decode_tokens_device([z for z, _ in CUT], s=1,
                                    max_steps=MAX_STEPS)
    for (col, outlen), (_, d) in zip(got, CUT):
        assert col is not None and outlen == len(d)
        assert resolve_tokens_np(col, outlen) == d[:-1] + b"\x00"
    port = it.inflate_device_tokens([z for z, _ in CUT], out_cap=65536,
                                    device="cpu")
    assert port == [None] * len(CUT)
