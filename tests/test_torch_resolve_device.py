"""The port's `ops.resolve.resolve_tokens_device` held to the JAX
package's function of that name on the CPU: the JAX function as XLA on
the CPU, the port's with device="cpu" (its plain version), on the cases
of tests/test_resolve_device.py. Tolerance: exact (equal lists, None in
the same places)."""

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.ops.resolve import (
    resolve_tokens_device as jax_resolve,
)
from libdeflate_rsx_tpu.ops.tokens import resolve_tokens_np
from libdeflate_rsx_tpu_torch.ops import resolve as rs
from tests.test_resolve_device import NOP, col, lit, match

torch.set_num_threads(2)


def random_batch():
    """16 seeded random streams of literals and matches (the batch of
    test_resolve_device.test_random_differential_many_streams)."""
    rng = np.random.default_rng(3)
    cols, cap = [], 2048
    for _ in range(16):
        toks, pos = [], 0
        while pos < cap - 300 and len(toks) < 900:
            if pos < 4 or rng.random() < 0.45:
                toks.append(lit(int(rng.integers(0, 256))))
                pos += 1
            else:
                length = int(rng.integers(3, 120))
                dist = int(rng.integers(1, pos + 1))
                toks.append(match(length, dist))
                pos += length
        cols.append(col(toks, 1024))
    return cols, cap


def per_offset(dist):
    toks = [lit((i * 37 + dist) & 0xFF) for i in range(dist)]
    toks += [match(258, dist)] * 6 + [match(17, dist)]
    return col(toks, 80)


def deep_chain():
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
    return [col(toks, len(toks))], pos + 64


CASES = {
    "literals only": ([col([lit(i & 0xFF) for i in range(40)], 64)], 128),
    "overlapping copies and depth-258 runs": ([col(c, 300) for c in [
        [lit(65), lit(66), lit(67), match(5, 3)],
        [lit(1), match(258, 1)],
        [lit(7), lit(8), match(4, 2), match(10, 6)],
        [lit(9)] * 30 + [match(20, 30), match(17, 5)]]], 512),
    "per-offset chains": ([per_offset(d) for d in
                           (1, 2, 3, 4, 7, 8, 18, 31, 32, 64)], 4096),
    "deep chain": deep_chain(),
    "NOPs": ([col([lit(10), NOP, NOP, lit(11), NOP, match(3, 2), NOP],
                  32)], 64),
    "a match before the start, past out_cap and at it": ([
        col([lit(1), lit(2), match(3, 2)], 16),
        col([lit(1), match(3, 2)], 16),
        col([lit(0)] * 10 + [match(258, 1)] * 3, 16),
        col([lit(5)] * 4 + [match(12, 4)], 16)], 20),
    "the exact cap": ([col([lit(5)] * 4 + [match(12, 4)], 8)], 16),
    "seeded random batch": random_batch(),
}


@pytest.mark.parametrize("name", list(CASES))
def test_resolve_tokens_device_equals_jax(name):
    cols, cap = CASES[name]
    toks = np.stack(cols)
    want = jax_resolve(toks, cap)
    got = rs.resolve_tokens_device(toks, cap, device="cpu")
    assert got == want
    assert [g is None for g in got] == [w is None for w in want]
    # the tensor form takes the same columns
    assert rs.resolve_tokens_device(torch.from_numpy(toks), cap,
                                    device="cpu") == want
    for c, g in zip(cols, got):
        assert g == resolve_tokens_np(c, cap)


def test_mixed_batch_has_none_where_jax_does():
    cols, cap = CASES["a match before the start, past out_cap and at it"]
    got = rs.resolve_tokens_device(np.stack(cols), cap, device="cpu")
    assert [g is None for g in got] == [False, True, True, False]


def test_empty_batch_and_empty_columns():
    launches = rs.LAUNCHES
    assert rs.resolve_tokens_device(np.zeros((0, 5), np.int32), 64,
                                    device="cpu") == []
    assert jax_resolve(np.zeros((0, 5), np.int32), 64) == []
    # T == 0: zero tokens decode to empty bytes in the port; the JAX
    # function cannot take the shape (it reads the last token's end)
    assert rs.resolve_tokens_device(np.zeros((3, 0), np.int32), 64,
                                    device="cpu") == [b""] * 3
    with pytest.raises(IndexError):
        jax_resolve(np.zeros((3, 0), np.int32), 64)
    assert rs.LAUNCHES == launches       # CPU tensors take the plain path


def test_default_device_is_the_card():
    """Without device= the function goes to the card; this CPU build of
    torch has none, so the default call raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default call would launch")
    with pytest.raises((AssertionError, RuntimeError)):
        rs.resolve_tokens_device(np.stack([col([lit(1)], 4)]), 16)
