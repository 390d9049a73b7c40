"""LZ copy resolution: the port's resolve_batch against the JAX package's
resolve_batch_jax and the numpy oracle resolve_tokens_np, exactly.

Cases are those of tests/test_resolve_device.py: literals, overlapping
copies, NOPs, per-offset periodic chains, deep chains, seeded random
columns, a match before the start and output past out_cap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.ops.resolve import resolve_batch_jax
from libdeflate_rsx_tpu.ops.tokens import (
    KIND_LIT,
    KIND_MATCH,
    KIND_NOP,
    KIND_SHIFT,
    resolve_tokens_np,
)
from libdeflate_rsx_tpu_torch.ops.resolve import resolve_batch

torch.set_num_threads(2)
NOP = KIND_NOP << KIND_SHIFT


def lit(b):
    return (KIND_LIT << KIND_SHIFT) | (b & 0xFF)


def match(length, dist):
    return (KIND_MATCH << KIND_SHIFT) | ((dist - 1) << 8) | (length - 3)


def col(tokens, T):
    a = np.full(T, NOP, np.int32)
    a[: len(tokens)] = np.array(tokens, np.int32)
    return a


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
        assert mine == resolve_tokens_np(c, out_cap)
        got.append(mine)
    return got


def test_literals_and_overlaps():
    cases = [
        [lit(i & 0xFF) for i in range(40)],
        [lit(65), lit(66), lit(67), match(5, 3)],
        [lit(1), match(258, 1)],
        [lit(7), lit(8), match(4, 2), match(10, 6)],
        [lit(9)] * 30 + [match(20, 30), match(17, 5)],
        [lit(10), NOP, NOP, lit(11), NOP, match(3, 2), NOP],
    ]
    got = check([col(c, 300) for c in cases], 512)
    assert got[0] == bytes(range(40))


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 7, 8, 18, 31, 32, 64])
def test_per_offset_patterns(dist):
    toks = [lit((i * 37 + dist) & 0xFF) for i in range(dist)]
    toks += [match(258, dist)] * 6 + [match(17, dist)]
    (got,) = check([col(toks, len(toks) + 8)], 4096)
    assert got[dist:2 * dist] == got[:dist]


def test_deep_chain_through_mixed_tokens():
    rng = np.random.default_rng(11)
    toks = [lit(int(b)) for b in rng.integers(0, 256, 64)]
    pos = 64
    for _ in range(200):
        length = int(rng.integers(3, 40))
        toks.append(match(length, min(int(rng.integers(1, pos)), 32768)))
        pos += length
        if rng.random() < 0.3:
            toks.append(lit(int(rng.integers(0, 256))))
            pos += 1
    check([col(toks, len(toks))], pos + 64)


def test_bad_cases():
    good = col([lit(1), lit(2), match(3, 2)], 16)
    before_start = col([lit(1), match(3, 2)], 16)     # dist 2 > pos 1
    past_cap = col([lit(0)] * 10 + [match(258, 1)] * 3, 16)
    exact = col([lit(5)] * 4 + [match(12, 4)], 16)    # outlen == cap
    got = check([good, before_start, past_cap, exact], 16)
    assert got[1] is None and got[2] is None
    assert len(got[3]) == 16


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_seeded_random_columns(seed):
    rng = np.random.default_rng(seed)
    cols, cap = [], 2048
    for _ in range(16):
        toks, pos = [], 0
        while pos < cap - 300 and len(toks) < 900:
            if pos < 4 or rng.random() < 0.45:
                toks.append(lit(int(rng.integers(0, 256))))
                pos += 1
            elif rng.random() < 0.1:
                toks.append(NOP)
            else:
                length = int(rng.integers(3, 120))
                toks.append(match(length, int(rng.integers(1, pos + 1))))
                pos += length
        cols.append(col(toks, 1024))
    check(cols, cap)
