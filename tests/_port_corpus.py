"""JAX-free test data for the PyTorch port, shared by its tests and by
`chip_smoke.py` (the card's machine need not have JAX, and
`tests/conftest.py` imports it).

`make_corpus` gives the same bytes as `tests/conftest.make_corpus`;
`tests/test_torch_import.py` holds the two equal.
"""

from __future__ import annotations

import random
import zlib


def make_corpus(kind: str, size: int, seed: int = 1234) -> bytes:
    """Seeded test data of one kind: pattern, text, random, zeros or
    periodic:N."""
    r = random.Random(seed)
    if kind == "pattern":
        base = bytes(r.randrange(256) for _ in range(100))
        return (base * (size // len(base) + 1))[:size]
    if kind == "text":
        words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over",
                 b"lazy", b"dog", b"compression", b"deflate", b"huffman",
                 b"tpu", b"kernel", b"stream"]
        out = bytearray()
        while len(out) < size:
            out += r.choice(words) + b" "
            if r.random() < 0.05:
                out += b"\n"
        return bytes(out[:size])
    if kind == "random":
        return bytes(r.randrange(256) for _ in range(size))
    if kind == "zeros":
        return b"\x00" * size
    if kind.startswith("periodic"):
        period = int(kind.split(":")[1])
        base = bytes(r.randrange(256) for _ in range(period))
        return (base * (size // period + 1))[:size]
    raise ValueError(kind)


def raw_z(data: bytes, level: int = 6) -> bytes:
    """zlib's raw-DEFLATE stream of data."""
    return zlib.compress(data, level)[2:-4]


def mutated_streams(n: int, seed: int = 5) -> list[bytes]:
    """n raw-DEFLATE streams with 1-3 flipped bits each, in the block
    header (even k) or anywhere (odd k): seeded inputs for the decoder's
    malformed-stream verdicts. Some still decode, to other bytes."""
    r = random.Random(seed)
    out = []
    for k in range(n):
        kind = ("text", "pattern", "random")[k % 3]
        d = make_corpus(kind, 300 + 13 * k, seed=100 + k)
        s = bytearray(raw_z(d, (1, 6, 9)[(k // 3) % 3]))
        span = min(len(s), 48) if k % 2 == 0 else len(s)
        for _ in range(1 + k % 3):
            bit = r.randrange(8 * span)
            s[bit >> 3] ^= 1 << (bit & 7)
        out.append(bytes(s))
    return out
