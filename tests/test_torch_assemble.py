"""The device block assembly (ops/assemble.py) on the CPU: its plain
version against the JAX package's numpy assemblers and stored fallback.

Rows of small blocks (4 KiB, one of random bytes) come from the port's
static, L4 and L6 encoders on the CPU, which tests/test_torch_encode_tiers.py
and test_torch_encode_l6.py hold to the JAX package's rows. Checked:

- `place_rows` gives each block the bytes of the JAX package's
  `encode_v2.assemble_blocks` (static) and `greedy_dynamic.assemble_dynamic`
  (L4, L6);
- `assemble` (placement, stored fallback, join) gives the bytes of the JAX
  package's `assemble_with_fallback` / `apply_stored_fallback`, with the
  random block stored; a 64 KiB random block becomes two stored chunks;
- a block past out_cap gets byte count -1 and `assemble` raises;
- a Python mirror of the kernel's join (csrc/assemble_rows.cu): each
  block's size from its byte count and stored cost, within the capacity
  the host allocates without a sync and, for a kept stream, within the
  block's build buffer; the offsets from the decoupled look-back over
  status words (windows of 32, the nearest inclusive sum), in any order
  of the thread blocks, equal to the exclusive scan; the joined bytes
  written as whole aligned words (a funnel shift of two source words)
  and byte-wise edges, equal to the plain join's; on a batch with stored
  blocks in the middle.

Tolerance: exact equality (bytes).
"""

import random
import zlib

import numpy as np
import pytest
import torch

from libdeflate_rsx_tpu.models import greedy_dynamic as jgd
from libdeflate_rsx_tpu.models import greedy_static as jgs
from libdeflate_rsx_tpu.ops import encode_v2 as jev
from libdeflate_rsx_tpu_torch.models import greedy_dynamic as pgd
from libdeflate_rsx_tpu_torch.models import greedy_static as pgs
from libdeflate_rsx_tpu_torch.ops import assemble as asm
from libdeflate_rsx_tpu_torch.ops import encode_dynamic as ped
from libdeflate_rsx_tpu_torch.ops import encode_v2 as pev
from libdeflate_rsx_tpu_torch.ops.dyn_tables import build_tables
from tests.conftest import make_corpus

torch.set_num_threads(2)
BLOCK = 4096
TIERS = ("static", "l4", "l6")


def mixed_data() -> bytes:
    """A text block, a random block (its streams expand: stored), then
    pattern bytes ending in a short final block."""
    return (make_corpus("text", BLOCK, seed=1)
            + make_corpus("random", BLOCK, seed=2)
            + make_corpus("pattern", BLOCK + 900, seed=3))


def tier_inputs(tier: str, data: bytes, block: int = BLOCK):
    """(assemble's inputs from the port's flow, the JAX numpy
    assembler's parts before the fallback, those parts after the JAX
    fallback)."""
    if tier == "static":
        arr, valid, finals, num = pgs.split_blocks(data, block)
        inputs = pgs.static_pass(arr, valid, finals, block, "cpu")
        dev_out = [t.numpy() for t in pev.encode_rows_static(
            *(torch.from_numpy(x) for x in (arr, valid, finals)), block)]
        want = jev.assemble_blocks(*dev_out, finals, num, inputs.out_cap)
        fell = jgs.assemble_with_fallback(data, block, dev_out, valid,
                                          finals, num)
        return inputs, want, fell
    if tier == "l4":
        arr, valid, finals, num = pgs.split_blocks(data, block)
        inputs, hists = pgd.dynamic_pass(arr, valid, finals, block, "cpu")
    else:
        arr, valid, hist, finals, num = pgd.split_blocks_hist(data, block)
        inputs, hists = pgd.dynamic_pass(arr, valid, finals, block, "cpu",
                                         hist)
        valid = valid - ped.HIST
    ll_tabs = build_tables(*hists, inputs.finals)[0]
    headers = [inputs.hdr[i, :(int(inputs.hdr_bits[i]) + 7) // 8].numpy()
               .tobytes() for i in range(num)]
    want = jgd.assemble_dynamic([t.numpy() for t in inputs[:4]], headers,
                                inputs.hdr_bits.numpy(), ll_tabs.numpy(),
                                finals, num, inputs.out_cap)
    fell = jgd.apply_stored_fallback(list(want), data, block, valid, finals,
                                     num)
    return inputs, want, fell


@pytest.fixture(scope="module")
def tiers():
    data = mixed_data()
    return data, {t: tier_inputs(t, data) for t in TIERS}


@pytest.mark.parametrize("tier", TIERS)
def test_place_rows_equals_jax_numpy_assembler(tier, tiers):
    _, by_tier = tiers
    args, want, _ = by_tier[tier]
    out, nbytes = asm.place_rows(*args[:8], args[10])
    assert out.dtype == torch.uint8 and out.shape[1] == args[10]
    got = [out[i, :int(nbytes[i])].numpy().tobytes()
           for i in range(out.shape[0])]
    assert got == want
    assert not out[torch.arange(out.shape[1]) >= nbytes[:, None]].any()


@pytest.mark.parametrize("tier", TIERS)
def test_fallback_and_join_equal_jax(tier, tiers):
    data, by_tier = tiers
    args, want, fell = by_tier[tier]
    joined, sizes = asm.assemble(*args)
    parts = asm.split_parts(joined, sizes)
    assert parts == fell
    assert sizes.tolist() == [len(p) for p in fell]
    stored = [p != w for p, w in zip(fell, want)]
    assert stored[1] and not stored[0], "the random block must be stored"
    assert zlib.decompress(b"".join(parts), -15) == data
    assert asm.LAUNCHES == 0                 # CPU tensors: plain versions


def test_stored_form_splits_at_65535():
    """A 64 KiB random block (non-final) becomes two stored chunks, the
    second ending the block, as the JAX package writes them."""
    data = make_corpus("random", 65536, seed=4) + make_corpus("text", 700)
    args, want, fell = tier_inputs("static", data, 65536)
    parts = asm.split_parts(*asm.assemble(*args))
    assert parts == fell and parts[0] != want[0]
    assert len(parts[0]) == 65536 + 10 and parts[0][0] == 0
    assert parts[0][65540] == 0 and parts[0][65541:65543] == b"\x01\x00"
    assert zlib.decompress(b"".join(parts), -15) == data


@pytest.mark.parametrize("tier", ("static", "l6"))
def test_block_past_out_cap_raises(tier, tiers):
    _, by_tier = tiers
    args, want, _ = by_tier[tier]
    cap = len(want[0]) - 1               # the first block does not fit
    out, nbytes = asm.place_rows(*args[:8], cap)
    assert int(nbytes[0]) == -1
    assert out.shape[1] == cap
    with pytest.raises(ValueError, match="output capacity"):
        asm.assemble(*args[:10], cap)


def test_empty_batch():
    out, nbytes = asm.place_rows(
        torch.zeros((0, 4, 49), dtype=torch.uint8),
        *(torch.zeros((0, 4), dtype=torch.int64),) * 2,
        torch.zeros(0, dtype=torch.int64),
        torch.zeros((0, 1), dtype=torch.uint8),
        *(torch.zeros(0, dtype=torch.int32),) * 2,
        torch.zeros(0, dtype=torch.bool), 64)
    joined, sizes = asm.join_rows(out, nbytes, torch.zeros((0, 8),
                                                           dtype=torch.uint8),
                                  torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, dtype=torch.bool))
    assert joined.shape == (0,) and sizes.shape == (0,)
    assert asm.split_parts(joined, sizes) == []


def test_static_v2_raises_past_out_cap(monkeypatch):
    """The level-1 encode without fallback raises for a block past its
    out_cap (byte count -1), as `join_rows` does, and returns only each
    block's bytes otherwise."""
    data = mixed_data()
    want = pev.deflate_device_static_v2(data, BLOCK, device="cpu")
    assert zlib.decompress(want, -15) == data
    monkeypatch.setattr(pgs, "_OUT_FACTOR", 0.1)
    with pytest.raises(ValueError, match="output capacity"):
        pev.deflate_device_static_v2(data, BLOCK, device="cpu")


AGGREGATE, INCLUSIVE = 1, 2


def look_back(status, b: int) -> int:
    """The kernel's look-back for block b: status words (flag, value) of
    its predecessors read 32 at a time, nearest first, up to and with
    the nearest inclusive sum."""
    excl, j = 0, b - 1
    while j >= 0:
        window = [status[j - lane] if j - lane >= 0 else (INCLUSIVE, 0)
                  for lane in range(32)]
        assert all(flag for flag, _ in window)     # published at start
        incl = [lane for lane, (flag, _) in enumerate(window)
                if flag == INCLUSIVE]
        if incl:
            return excl + sum(v for _, v in window[:incl[0] + 1])
        excl += sum(v for _, v in window)
        j -= 32
    return excl


def scan_offsets(sizes, seed: int) -> list[int]:
    """Every block publishes its size as an aggregate when it starts
    (block 0 as an inclusive sum); then the blocks finish their
    look-backs in a random order, each publishing its inclusive sum."""
    status = [(AGGREGATE, s) for s in sizes]
    offsets = [0] * len(sizes)
    if sizes:
        status[0] = (INCLUSIVE, sizes[0])
    order = list(range(1, len(sizes)))
    random.Random(seed).shuffle(order)
    for b in order:
        offsets[b] = look_back(status, b)
        status[b] = (INCLUSIVE, offsets[b] + sizes[b])
    return offsets


def write_range(joined: bytearray, off: int, src: bytes) -> None:
    """The kernel's write of src at joined[off:]: a word wholly inside
    the range from two source words, an edge word byte by byte."""
    end = off + len(src)
    padded = src + bytes(4)
    for w in range(off >> 2, ((end - 1) >> 2) + 1):
        lo, hi = 4 * w, 4 * w + 4
        if lo >= off and hi <= end:
            t = lo - off
            i, sh = t >> 2, t & 3
            assert sh == 0 or 4 * i + 4 < len(src)   # both words are the
            pair = int.from_bytes(padded[4 * i:4 * i + 8], "little")
            joined[lo:hi] = ((pair >> (8 * sh)) & 0xFFFFFFFF).to_bytes(
                4, "little")                          # stream's own
        else:
            for x in range(max(lo, off), min(hi, end)):
                joined[x] = src[x - off]


def stored_form(raw: bytes, final: bool) -> bytes:
    """The kernel's stored_byte over the whole stored form."""
    out, chunks = b"", max(1, -(-len(raw) // 65535))
    for c in range(chunks):
        body = raw[c * 65535:(c + 1) * 65535]
        n = len(body)
        out += bytes([int(final and c == chunks - 1), n & 0xFF, n >> 8,
                      ~n & 0xFF, (~n >> 8) & 0xFF]) + body
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_join_mirror_capacity_and_offsets(tier):
    data = (make_corpus("text", BLOCK, seed=5)
            + make_corpus("random", BLOCK, seed=6)
            + make_corpus("text", BLOCK, seed=7)
            + make_corpus("random", BLOCK, seed=8)
            + make_corpus("pattern", BLOCK + 300, seed=9))
    args = tier_inputs(tier, data)[0]
    out, nbytes = asm.place_rows_plain(*args[:8], args.out_cap)
    want, want_sizes = asm.join_rows_plain(out, nbytes, *args[8:10],
                                           args.finals)
    raw, raw_len = args.raw, args.raw_len.tolist()
    nb = nbytes.tolist()
    cost = [asm.stored_cost(v) for v in raw_len]
    stored = [n > c for n, c in zip(nb, cost)]
    sizes = [c if st else n for n, c, st in zip(nb, cost, stored)]
    assert sizes == want_sizes.tolist()
    assert [i for i, st in enumerate(stored) if st] == [1, 3]
    words = -(-min(args.out_cap, asm.stored_cost(raw.shape[1])) // 4)
    assert all(n <= 4 * words for n, st in zip(nb, stored) if not st)
    assert sum(sizes) <= asm.joined_capacity(len(sizes), raw.shape[1])
    scan = [sum(sizes[:b]) for b in range(len(sizes))]
    for seed in range(4):
        assert scan_offsets(sizes, seed) == scan
    joined = bytearray(asm.joined_capacity(len(sizes), raw.shape[1]))
    for b, off in enumerate(scan):
        src = (stored_form(raw[b, :raw_len[b]].numpy().tobytes(),
                           bool(args.finals[b])) if stored[b]
               else out[b, :nb[b]].numpy().tobytes())
        write_range(joined, off, src)
    assert bytes(joined[:sum(sizes)]) == want.numpy().tobytes()


def test_look_back_over_many_windows():
    """Sizes of 300 blocks (past 32-block windows, some 0): the offsets
    are the exclusive scan in any order of the thread blocks."""
    sizes = np.random.default_rng(3).integers(0, 70000, 300).tolist()
    sizes[40:80] = [0] * 40
    scan = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    for seed in range(8):
        assert scan_offsets(sizes, seed) == scan
