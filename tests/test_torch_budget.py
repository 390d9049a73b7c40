"""The memory budget of one device pass (libdeflate_rsx_tpu_torch/
budget.py): with the budget shrunk, the L4 and L6 batched compress and
the two-pass decode (both resolves) run in 3 or more passes, and their
bytes, decodes and host-fallback counts equal those of one pass.
Tolerance: exact equality (bytes and counts)."""

import collections
import zlib

import pytest
import torch

from libdeflate_rsx_tpu_torch import BatchDecompressor, budget
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as pgd
from libdeflate_rsx_tpu_torch.models import greedy_static as pgs
from tests._port_corpus import make_corpus, mutated_streams, raw_z

torch.set_num_threads(2)
BLOCK = 16384


@pytest.fixture
def shrink(monkeypatch):
    """Set the budget to `n` bytes (None: unbounded) and clear the pass
    counts."""
    def set_limit(n):
        monkeypatch.setattr(budget, "LIMIT", n)
        budget.PASSES.clear()
    yield set_limit
    budget.PASSES.clear()


def test_passes_split_in_order_under_the_limit(shrink):
    coef = budget.PEAK_PER_BYTE["decode"]
    shrink(10 * coef)
    assert budget.passes("decode", [4, 4, 4, 9, 1, 12, 3], "cpu") == \
        [(0, 2), (2, 3), (3, 5), (5, 6), (6, 7)]
    assert budget.PASSES["decode"] == 5
    assert budget.passes("decode", [], "cpu") == []
    shrink(None)
    assert budget.passes("decode", [4, 99], "cpu") == [(0, 2)]
    assert budget.estimate("decode", [4, 99]) == 103 * coef


def test_limit_splits_the_card_among_its_ranks(shrink, monkeypatch):
    """On a card the budget is FREE_SHARE of its free memory plus this
    process's cached blocks, split among the SHARERS ranks on it; LIMIT,
    when set, stands as it is."""
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (60 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 12 * gib)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 2 * gib)
    shrink(None)
    whole = int(budget.FREE_SHARE * 70 * gib)
    assert budget.limit("cuda") == whole
    monkeypatch.setattr(budget, "SHARERS", 2)
    assert budget.limit("cuda") == whole // 2
    unit = budget.estimate("decode", [1 << 20])
    per_rank = budget.passes("decode", [1 << 20] * 600, "cuda")
    assert len(per_rank) == -(-600 * unit // (whole // 2))
    assert budget.limit("cpu") is None
    shrink(1000)
    assert budget.limit("cuda") == 1000


@pytest.fixture(scope="module")
def items():
    """Three items of mixed kinds, 7 blocks of BLOCK in all (the last
    item short of a block)."""
    return [make_corpus("text", 2 * BLOCK + 100, seed=1),
            make_corpus("random", BLOCK + 7, seed=2),
            make_corpus("pattern", 2 * BLOCK - 5, seed=3)]


@pytest.mark.parametrize("name,kind,width", [
    ("deflate_device_dynamic_many", "dynamic", BLOCK),
    ("deflate_device_l6_many", "l6", pgd.HIST + BLOCK)])
def test_many_compress_in_budget_passes_equals_one_pass(shrink, items, name,
                                                        kind, width):
    many = getattr(pgd, name)
    shrink(None)
    one = many(items, block_size=BLOCK, device="cpu")
    assert budget.PASSES[kind] == 1
    row = budget.estimate(kind, [width + pgd.BLOCK_PAD])
    shrink(2 * row)                  # two rows a pass: 7 rows, 4 passes
    split = many(items, block_size=BLOCK, device="cpu")
    assert budget.PASSES[kind] == 4
    assert split == one
    shrink(row // 3)                 # a row alone is over the budget
    alone = many(items, block_size=BLOCK, device="cpu")
    assert budget.PASSES[kind] == 7
    assert alone == one
    for d, c in zip(items, one):
        assert zlib.decompress(c, -15) == d


def test_static_tier_in_budget_passes_equals_one_pass(shrink, items):
    data = b"".join(items)
    shrink(None)
    one = pgs.deflate_device_static(data, BLOCK, device="cpu")
    row = budget.estimate("static", [BLOCK + pgs.BLOCK_PAD])
    shrink(2 * row)                  # 6 rows, two a pass
    split = pgs.deflate_device_static(data, BLOCK, device="cpu")
    assert budget.PASSES["static"] == 3
    assert split == one and zlib.decompress(one, -15) == data


def decode_jobs():
    """Twelve streams with their max_out: good ones, one stopped at the
    batch's 16 KiB out_cap and one past its own max_out (both "max_out"),
    bit-flipped and garbage ones ("pass1")."""
    good = [make_corpus(k, 3000 + 500 * i, seed=i) for i, k in
            enumerate(("text", "pattern", "random", "text", "zeros"))]
    jobs = [(raw_z(d), len(d)) for d in good]
    big = make_corpus("pattern", 20000, seed=9)
    jobs.append((raw_z(big), 16384))        # stops at the out_cap
    jobs.append((raw_z(good[0]), 100))      # over its own max_out
    jobs += [(m, 4000) for m in mutated_streams(4, seed=3)]
    jobs.append((b"\xff" * 50, 1000))
    return jobs


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_two_pass_decode_in_budget_passes_equals_one_pass(shrink, resolve):
    jobs = decode_jobs()
    streams, caps = [j[0] for j in jobs], [j[1] for j in jobs]

    def run():
        bd = BatchDecompressor(use_device=True, resolve=resolve,
                               device="cpu")
        return bd.decompress_batch(streams, caps), bd.fallbacks

    shrink(None)
    one, fb_one = run()
    assert budget.PASSES["decode"] == 1
    assert fb_one["max_out"] == 2 and fb_one["pass1"] >= 1
    unit = budget.estimate("decode", [16384])
    shrink(4 * unit)                 # four streams a pass: 3 passes
    split, fb_split = run()
    assert budget.PASSES["decode"] == 3
    assert split == one and fb_split == fb_one
    shrink(unit // 2)                # every stream alone over the budget
    alone, fb_alone = run()
    assert budget.PASSES["decode"] == len(jobs)
    assert alone == one and fb_alone == fb_one
    assert one[:5] == [zlib.decompress(s, -15) for s in streams[:5]]
    assert isinstance(fb_one, collections.Counter)
