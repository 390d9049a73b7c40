"""The port on a CUDA card: the pass-1 kernel against its plain PyTorch
version on the card, and the slice through the kernel. Every test here
needs a card and skips without one.

Run on a machine with a card (the suite's conftest.py imports jax, which
such a machine need not have): python -m pytest --noconftest
tests/test_torch_cuda.py
"""

import random
import zlib

import pytest
import torch

from _port_corpus import make_corpus, mutated_streams

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _z(data, level=6):
    return zlib.compress(data, level)[2:-4]


def _cases():
    streams = []
    for lvl in (0, 1, 6, 9):
        for kind in ("text", "random", "pattern", "zeros", "periodic:7"):
            streams.append(_z(make_corpus(kind, 2000 + 37 * lvl, seed=lvl),
                              lvl))
    r = random.Random(11)
    good = make_corpus("text", 3000, seed=1)
    streams += [bytes(r.randrange(256) for _ in range(600)),
                _z(good)[:250], b"\x07\x00", _z(b""), _z(b"x")]
    return streams + mutated_streams(96, seed=6)


@pytest.mark.parametrize("out_cap", [1024, 65536, 1 << 20])
def test_kernel_equals_plain_on_card(card, out_cap):
    """Tokens and stats equal, including streams that overflow out_cap
    and malformed ones; the kernel launch is counted."""
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams(_cases(), 65536, card)[:3]
    before = it.LAUNCHES
    tok_k, st_k = it.pass1(*args, out_cap)
    assert it.LAUNCHES == before + 1
    tok_p, st_p = it.pass1_plain(*args, out_cap)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_p)
    assert torch.equal(tok_k, tok_p)


def test_empty_batch_launches_nothing(card):
    from libdeflate_rsx_tpu_torch.ops import inflate_tokens as it

    args = it.pack_streams([], 65536, card)[:3]
    before = it.LAUNCHES
    tokens, stats = it.pass1(*args, 64)
    assert tokens.shape == (0, 64) and stats.shape == (0, 4)
    assert it.LAUNCHES == before


def test_slice_on_card_equals_slice_on_cpu(card):
    from libdeflate_rsx_tpu_torch import BatchCompressor, BatchDecompressor

    datas = [make_corpus("text", 70000, seed=1), make_corpus("pattern", 9000),
             make_corpus("random", 3000, seed=2)]
    gpu = BatchCompressor(level=6, use_device=True,
                          device=card).compress_batch(datas)
    cpu = BatchCompressor(level=6, use_device=True,
                          device="cpu").compress_batch(datas)
    assert gpu == cpu
    for resolve in ("device", "host"):
        bd = BatchDecompressor(use_device=True, resolve=resolve, device=card)
        got = bd.decompress_batch(gpu + [b"\xff\x07garbage"],
                                  [len(d) for d in datas] + [100])
        assert got == datas + [None]
        assert dict(bd.fallbacks) == {"pass1": 1}
