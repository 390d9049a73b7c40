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



def cut_stored_streams(seed: int = 41) -> list[tuple[bytes, bytes]]:
    """(stream cut by one byte, original): raw-DEFLATE streams of random
    bytes whose final block is a stored block that holds data, at zlib
    levels 0 and 6 (one block), and at level 0 with a full flush before
    the final block (a non-final stored block, the empty one of the
    flush, then the final one). Cut by one byte, each loses the last
    byte of its final stored block: the decoders must reject them.
    Short enough for the JAX pass-1 kernel's 2048-step bucket (a stored
    byte is one of its steps)."""
    r = random.Random(seed)
    out = []
    for level in (0, 6):
        for n in (1, 2, 31, 100, 257, 600, 1000, 1500):
            d = r.randbytes(n)
            z = raw_z(d, level)
            if z[0] & 7 == 1:              # one final stored block
                out.append((z[:-1], d))
    for a, b in ((300, 200), (1000, 1)):
        d = r.randbytes(a + b)
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        z = co.compress(d[:a]) + co.flush(zlib.Z_FULL_FLUSH) \
            + co.compress(d[a:]) + co.flush()
        out.append((z[:-1], d))
    return out

# ------------------------------------------- hand-built edge-case streams
# Rows and streams at the edges of the stream kernels' staging and copies
# (a row filled to its last byte, bits read past it, bytes past a
# stream's end, long and short distances, subtables of 15-bit codes),
# short or stored so that the plain versions decode them in few steps.

IN_CAP = 65536          # bytes of a stream kernel's input row
_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
             43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EB = [0] * 8 + [k for k in range(1, 6) for _ in range(4)] + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
              257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
              12289, 16385, 24577]
_DIST_EB = [max(0, k // 2 - 1) for k in range(30)]


def _sym(base, value):
    """The symbol of a length or distance and its extra-bit value."""
    s = max(k for k, b in enumerate(base) if b <= value)
    return s, value - base[s]


class BitWriter:
    """DEFLATE's bit order: fields LSB first, Huffman codes MSB first."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def bits(self, v, n):
        self.acc |= v << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def code(self, c, n):
        c &= (1 << n) - 1           # an over-subscribed code's codes wrap
        self.bits(int(format(c, f"0{n}b")[::-1], 2) if n else 0, n)

    def align(self):
        if self.n % 8:
            self.bits(0, 8 - self.n % 8)

    def data(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def canonical(lens):
    """Canonical code of each symbol from its length (0: none)."""
    nxt, code = {}, 0
    for l in range(1, 16):
        code = (code + sum(1 for x in lens if x == l - 1 and x)) << 1
        nxt[l] = code
    out = []
    for x in lens:
        out.append(nxt[x] if x else 0)
        if x:
            nxt[x] += 1
    return out


def _static_ll(s):
    if s < 144:
        return 0x30 + s, 8
    if s < 256:
        return 0x190 + s - 144, 9
    if s < 280:
        return s - 256, 7
    return 0xC0 + s - 280, 8


def _tokens(w, tokens, ll, of):
    """Literals (int) and matches (length, dist) through the codes ll(sym)
    and of(sym) -> (code, bits), then end-of-block."""
    for t in tokens:
        if isinstance(t, int):
            w.code(*ll(t))
            continue
        ls, lx = _sym(_LEN_BASE, t[0])
        if t[0] == 258:
            ls, lx = 28, 0
        w.code(*ll(257 + ls))
        w.bits(lx, _LEN_EB[ls])
        ds, dx = _sym(_DIST_BASE, t[1])
        w.code(*of(ds))
        w.bits(dx, _DIST_EB[ds])
    w.code(*ll(256))


def stored_block(w, data, final, length=None):
    n = len(data) if length is None else length
    w.bits(final, 1)
    w.bits(0, 2)
    w.align()
    w.bits(n, 16)
    w.bits(n ^ 0xFFFF, 16)
    w.out += data


def static_block(w, tokens, final):
    w.bits(final, 1)
    w.bits(1, 2)
    _tokens(w, tokens, _static_ll, lambda s: (s, 5))


def dynamic_block(w, tokens, final, ll_lens, of_lens):
    """A dynamic block with all 286 litlen and 30 distance lengths sent
    through a precode of sixteen 4-bit codes (symbols 0-15, no runs)."""
    w.bits(final, 1)
    w.bits(2, 2)
    w.bits(286 - 257, 5)
    w.bits(30 - 1, 5)
    w.bits(19 - 4, 4)
    for s in (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
              15):
        w.bits(0 if s > 15 else 4, 3)
    for x in list(ll_lens) + list(of_lens):
        w.code(x, 4)
    llc, ofc = canonical(ll_lens), canonical(of_lens)
    _tokens(w, tokens, lambda s: (llc[s], ll_lens[s]),
            lambda s: (ofc[s], of_lens[s]))


def _long_code_block(r, n):
    """A dynamic block whose litlen code has 12-, 14- and 15-bit codes
    (subtables under root slots) and whose distance code has 14- and
    15-bit codes, with a body that uses them after n bytes of history."""
    short = [ord(c) for c in "et aoinsr"]           # lengths 1..9
    long_lits = [k for k in range(256) if k not in short][:24]
    ll = [0] * 286
    for k, s in enumerate(short):
        ll[s] = k + 1
    # the rest 2**-9 of the code space: 4 codes of 12, 8 of 14, 16 of 15
    rest = long_lits + [256, 257, 265, 284]
    for k, s in enumerate(rest):
        ll[s] = 12 if k < 4 else (14 if k < 12 else 15)
    of = [0] * 30
    for k, s in enumerate([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 20]):
        of[s] = k + 1
    of[29], of[16] = 15, 15
    dists = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 1025, 257, 24577]
    toks = []
    for _ in range(600):
        if r.random() < 0.6 or n < 3:
            toks.append(r.choice(short + rest[:24]))
            n += 1
        else:
            d = r.choice([x for x in dists if x <= n])
            ln = r.choice([3, 11, 12, 227, 257])
            toks.append((ln, d))
            n += ln
    return toks, ll, of


def edge_cases():
    """(name, stream, tail): each stream's row holds the stream and then
    `tail` (bytes that lie past the stream's end), zeros after it."""
    r = random.Random(29)
    rnd = lambda n: bytes(r.randrange(256) for _ in range(n))  # noqa: E731
    cases = []
    # a stored stream that fills the row to its last byte, and a stored
    # block of 65,535 bytes cut at the row's end
    w = BitWriter()
    stored_block(w, rnd(IN_CAP - 5), 1)
    cases.append(("stored-full-row", w.data(), b""))
    w = BitWriter()
    stored_block(w, rnd(IN_CAP - 5), 1, length=65535)
    cases.append(("stored-65535-cut", w.data(), b""))
    w = BitWriter()
    stored_block(w, rnd(IN_CAP - 15), 0)
    stored_block(w, rnd(5), 1)
    cases.append(("stored-two-blocks-full-row", w.data(), b""))
    # a row filled to its last byte by a static block that goes on past
    # it: the last symbols read bits past the row
    w = BitWriter()
    stored_block(w, rnd(65000), 0)
    static_block(w, [r.randrange(144, 256) for _ in range(700)], 1)
    cases.append(("static-past-row", w.data()[:IN_CAP], b""))
    # matches of 258 at distance 32,768 after a stored block
    w = BitWriter()
    stored_block(w, rnd(32768), 0)
    static_block(w, [(258, 32768)] * 100, 1)
    cases.append(("match-258-at-32768", w.data(), b""))
    # distances 31, 32, 33 and 64 at lengths around them
    toks = [(ln, d) for d in (31, 32, 33, 64)
            for ln in (3, 8, 30, 31, 32, 33, 34, 63, 64, 65, 100, 258)]
    w = BitWriter()
    stored_block(w, rnd(64), 0)
    static_block(w, toks + [65, 66], 1)
    cases.append(("distances-31-32-33-64", w.data(), b""))
    # 15-bit litlen and distance codes
    w = BitWriter()
    stored_block(w, rnd(30000), 0)
    toks, ll, of = _long_code_block(r, 30000)
    dynamic_block(w, toks, 1, ll, of)
    cases.append(("dynamic-15-bit-codes", w.data(), b""))
    w = BitWriter()
    toks, ll, of = _long_code_block(r, 0)
    dynamic_block(w, toks, 1, ll, of)
    long_codes = w.data()
    # over-subscribed codes: the TPU kernel's table fill then allocates a
    # subtable for each long code, sized from the slot as it finds it (a
    # shorter code covering it, or the longest excess under it), and may
    # pass its table (BAD_TABLE)
    for name, ll, of in (
            ("oversub-short-first", [5] * 33 + [15] * 250 + [0] * 3, [5] * 30),
            ("oversub-long-first", [15] * 250 + [5] * 33 + [0] * 3, [15] * 30),
            ("oversub-fits", [1, 1, 1] + [0] * 253 + [15] * 4 + [0] * 26,
             [5] * 30)):
        w = BitWriter()
        dynamic_block(w, [], 1, ll, of)
        cases.append((name, w.data(), b""))
    # bytes past the stream's end: whole, cut short, cut inside the
    # dynamic header
    text = make_corpus("text", 4000, seed=31)
    fixed = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    fz = fixed.compress(text) + fixed.flush()
    for name, z in (("dynamic", raw_z(text)), ("static", fz),
                    ("long-codes", long_codes)):
        tail = b"\xff" * 8 + rnd(120)
        cases += [(f"{name}-tail", z, tail),
                  (f"{name}-cut-tail", z[:len(z) // 2], tail),
                  (f"{name}-header-cut-tail", z[:9], tail)]
    return cases


def edge_rows(cases):
    """(lens (B,) int32, words (B, IN_CAP // 4) int32) numpy arrays of
    edge_cases(): each row the stream, its tail, then zeros."""
    import numpy as np
    lens = np.array([len(z) for _, z, _ in cases], np.int32)
    buf = np.zeros((len(cases), IN_CAP), np.uint8)
    for i, (_, z, tail) in enumerate(cases):
        row = (z + tail)[:IN_CAP]
        buf[i, :len(row)] = np.frombuffer(row, np.uint8)
    return lens, buf.view("<i4")


# ------------------------------------------------- pass-2 token columns
# Hand-built token columns (the ops/tokens.py format) for LZ copy
# resolution: the cases of tests/test_torch_resolve.py, shared with the
# card's checks of the resolve kernel (chip_smoke.py phase 24 and
# tests/test_torch_cuda.py). Each builder returns (columns, out_cap).

KIND_SHIFT = 29
NOP = 0
KIND3 = 3 << KIND_SHIFT          # a kind no decoder emits; it emits nothing


def lit(b):
    return (1 << KIND_SHIFT) | (b & 0xFF)


def match(length, dist):
    return (2 << KIND_SHIFT) | ((dist - 1) << 8) | (length - 3)


def col(tokens, T):
    """A column of T tokens: these, then NOPs."""
    import numpy as np

    a = np.full(T, NOP, np.int32)
    a[: len(tokens)] = np.array(tokens, np.int32)
    return a


def overlap_columns():
    """Literals, overlapping copies and NOPs."""
    cases = [
        [lit(i & 0xFF) for i in range(40)],
        [lit(65), lit(66), lit(67), match(5, 3)],
        [lit(1), match(258, 1)],
        [lit(7), lit(8), match(4, 2), match(10, 6)],
        [lit(9)] * 30 + [match(20, 30), match(17, 5)],
        [lit(10), NOP, NOP, lit(11), NOP, match(3, 2), NOP],
    ]
    return [col(c, 300) for c in cases], 512


def offset_columns(dist):
    """One period of literals, then copies at that distance."""
    toks = [lit((i * 37 + dist) & 0xFF) for i in range(dist)]
    toks += [match(258, dist)] * 6 + [match(17, dist)]
    return [col(toks, len(toks) + 8)], 4096


def deep_chain_columns():
    """200 matches reaching back into each other, literals between."""
    import numpy as np

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


def bad_columns():
    """A good column, a match before the start, output past out_cap and
    output ending at out_cap."""
    return [col([lit(1), lit(2), match(3, 2)], 16),
            col([lit(1), match(3, 2)], 16),                # dist 2 > pos 1
            col([lit(0)] * 10 + [match(258, 1)] * 3, 16),
            col([lit(5)] * 4 + [match(12, 4)], 16)], 16    # outlen == cap


def random_columns(seed, n=16, cap=2048, T=1024, ntok=900, kind3=False):
    """Seeded columns of up to ntok literals, matches and NOPs (and
    kind-3 tokens) filling most of out_cap."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(n):
        toks, pos = [], 0
        while pos < cap - 300 and len(toks) < ntok:
            if pos < 4 or rng.random() < 0.45:
                toks.append(lit(int(rng.integers(0, 256))))
                pos += 1
            elif rng.random() < 0.1:
                toks.append(NOP)
            elif kind3 and rng.random() < 0.1:
                toks.append(KIND3 | int(rng.integers(0, 1 << 29)))
            else:
                length = int(rng.integers(3, 120))
                toks.append(match(length, int(rng.integers(
                    1, min(pos, 32768) + 1))))
                pos += length
        cols.append(col(toks, T))
    return cols, cap


def dist1_run_columns(cap=1 << 20):
    """1 MiB of one byte, as zlib-6 codes it: a literal, then matches of
    258 at distance 1 (the chain is as deep as the matches are many),
    ending exactly at out_cap."""
    n, rest = divmod(cap - 1, 258)
    toks = [lit(0x5A)] + [match(258, 1)] * n
    if rest:
        toks.append(match(rest, 1) if rest >= 3 else lit(0x5A))
    return [col(toks, len(toks))], cap


def chained_d4_columns(cap=1 << 20):
    """1 MiB of a 4-byte period coded as matches of 8 at distance 4, each
    reading the one before (the deepest chain per byte that a match
    length of 8 allows), ending exactly at out_cap."""
    n, rest = divmod(cap - 4, 8)
    toks = [lit(1), lit(2), lit(3), lit(4)] + [match(8, 4)] * n
    if rest:
        toks.append(match(rest, 4))
    return [col(toks, len(toks))], cap


def periodic_columns(cap=65536):
    """Periodic chains at distances 2..33: one period of literals, then
    matches of 258 at that distance to near out_cap."""
    cols = []
    for d in range(2, 34):
        toks = [lit((7 * i + d) & 0xFF) for i in range(d)]
        toks += [match(258, d)] * ((cap - d) // 258)
        cols.append(col(toks, 300))
    return cols, cap


def far_columns(cap=1 << 18):
    """Matches at distance 32,768 that cross several windows: 32 KiB of
    seeded literals, then long and short matches at the largest
    distance, mixed with literals and matches at other distances."""
    import numpy as np

    rng = np.random.default_rng(21)
    first = [lit(int(b)) for b in rng.integers(0, 256, 32768)]
    plain = first + [match(258, 32768)] * 400
    mixed = list(first)
    pos = 32768
    while pos < cap - 600:
        r = rng.random()
        if r < 0.5:
            length = int(rng.integers(3, 259))
            mixed.append(match(length, 32768))
        elif r < 0.8:
            length = int(rng.integers(3, 259))
            mixed.append(match(length, int(rng.integers(1, 32769))))
        else:
            length = 1
            mixed.append(lit(int(rng.integers(0, 256))))
        pos += length
    T = max(len(plain), len(mixed))
    return [col(plain, T), col(mixed, T)], cap


def before_start_columns():
    """Matches that reach before the start of the output: first, in a
    later window, and one byte too far; and a column that reaches exactly
    to the start."""
    far = [lit(3)] * 20000 + [match(10, 20001)]
    ok = [lit(3)] * 20000 + [match(10, 20000)]
    cols = [[match(3, 1)], far, ok, [lit(1)] * 5 + [match(258, 6)]]
    return [col(c, len(far)) for c in cols], 65536


def past_cap_columns(cap=65536):
    """Sums at out_cap, one byte past it (by a literal and by a match's
    last byte) and far past it."""
    n = (cap - 1) // 258
    at = [lit(1)] + [match(258, 1)] * n + [lit(2)] * (cap - 1 - 258 * n)
    assert len(at) - n >= 3
    cols = [at, at + [lit(9)], at[:-2] + [match(3, 1)],
            [lit(1)] + [match(258, 1)] * (2 * cap // 258)]
    T = max(map(len, cols))
    return [col(c, T) for c in cols], cap


def nop_kind3_columns(seed=8):
    """NOPs and kind-3 tokens anywhere: first, last, between matches and
    in runs, in columns that cross several windows."""
    import numpy as np

    cols, cap = random_columns(seed, n=8, cap=1 << 17, T=40000, ntok=39990,
                               kind3=True)
    rng = np.random.default_rng(seed)
    out = []
    for c in cols:
        k = int(rng.integers(100, 1000))
        out.append(np.concatenate([
            [KIND3 | 0x1FF], c[:k], [NOP, KIND3, NOP, KIND3 | 0x3FF, NOP],
            c[k:], [KIND3]]).astype(np.int32))
    return out, cap


def _resolve_builders():
    b = {"literals and overlaps": overlap_columns}
    for d in (1, 2, 3, 4, 7, 8, 18, 31, 32, 64):
        b[f"offset {d}"] = lambda d=d: offset_columns(d)
    b["deep chain"] = deep_chain_columns
    b["bad cases"] = bad_columns
    for seed in (3, 4, 5):
        b[f"random seed {seed}"] = lambda seed=seed: random_columns(seed)
    b.update({"dist-1 run of 1 MiB": dist1_run_columns,
              "periodic d 2..33": periodic_columns,
              "d 32768 across windows": far_columns,
              "before the start": before_start_columns,
              "past out_cap": past_cap_columns,
              "NOP and kind 3": nop_kind3_columns})
    for seed in (30, 31):
        b[f"random kind 3 seed {seed}"] = lambda seed=seed: random_columns(
            seed, cap=1 << 16, T=12000, ntok=11990, kind3=True)
    b["chained d-4 run of 1 MiB"] = chained_d4_columns
    b["random 512 KiB seed 32"] = lambda: random_columns(
        32, n=3, cap=1 << 19, T=60000, ntok=59990, kind3=True)
    return b


#: label -> builder of (columns, out_cap), every hand-built case above
RESOLVE_CASES = _resolve_builders()


def resolve_cases():
    """[(label, columns, out_cap)] of every hand-built case above."""
    return [(label, *build()) for label, build in RESOLVE_CASES.items()]


# --------------------------------------------------------- L6 match windows
L6_HIST = 32768         # the L6 tier's history prefix (bytes)
L6_ROW_PAD = 266        # bytes past a window in its row (BLOCK_PAD)


def l6_windows(block: int = 16384, seed: int = 11):
    """Seeded [history | payload] windows of HIST + block bytes that hit
    the L6 match finder's traps: (labels, rows (B, s + L6_ROW_PAD) uint8,
    valid (B,) int32, hist_start (B,) int32, s). The row bytes past
    `valid` are zero, as the encode flow pads them."""
    import numpy as np

    s = L6_HIST + block
    rng = np.random.default_rng(seed)
    text = np.frombuffer(make_corpus("text", s, seed=seed), np.uint8)
    out = []

    def add(label, body, valid=s, hist_start=0):
        row = np.zeros(s + L6_ROW_PAD, np.uint8)
        row[:valid] = body[:valid]
        out.append((label, row, valid, hist_start))

    add("text", text)
    # the smallest word of the window (1, 0, 0, 0) six times: the first
    # positions of the sorted order lose candidates (the rank rule)
    small = rng.integers(16, 256, s, dtype=np.uint8)
    tok = np.concatenate([[1, 0, 0, 0], rng.integers(16, 256, 8)])
    for p in (20000, 26000, 31000, 35000, 39000, 44000):
        small[p:p + 12] = tok
    add("smallest word 6 times", small)
    add("hist_start HIST", small, hist_start=L6_HIST)
    add("hist_start 16384", small, hist_start=16384)
    add("zeros", np.zeros(s, np.uint8))
    add("valid_len < s", text, valid=40000)
    far = rng.integers(0, 256, s, dtype=np.uint8)
    for d, at in ((32767, 33000), (32768, 40000), (32769, 45000)):
        far[at:at + 40] = far[at - d:at - d + 40]
    add("distances 32767-32769", far)
    # a 400-byte repeat (the decay spreads it), a run of a 24-byte period
    # (equal lengths from the base tier and the ladder) and a copy of it
    spread = rng.integers(0, 256, s, dtype=np.uint8)
    spread[20000:20400] = spread[15000:15400]
    spread[30000:31000] = np.resize(rng.integers(0, 256, 24), 1000)
    spread[41000:41130] = spread[30003:30133]
    add("long match and ties", spread)
    # matches that run into the window's tail and the zero padding
    tail = rng.integers(0, 256, s, dtype=np.uint8)
    tail[s - 150:] = tail[s - 9000:s - 8850]
    tail[s - 300:s - 200] = 0
    tail[s - 60:] = 0
    add("tail and padding", tail)
    zero_runs = text.copy()
    for p in (9000, 23000, 47000):
        zero_runs[p:p + 6] = 0
    add("three 6-byte zero runs", zero_runs)
    add("periodic 7", np.frombuffer(make_corpus("periodic:7", s, seed=2),
                                    np.uint8))
    first = np.zeros(s, np.uint8)
    first[L6_HIST:] = text[:block]
    add("first block", first, hist_start=L6_HIST)
    labels = [o[0] for o in out]
    return (labels, np.stack([o[1] for o in out]),
            np.array([o[2] for o in out], np.int32),
            np.array([o[3] for o in out], np.int32), s)


# ------------------------------------------------- selection edge arrays
SELECT_S = L6_HIST + 8192   # window of the selection edge arrays


def select_cases(seed: int = 13):
    """Seeded match-finder outputs that hit the selection's traps, in
    windows of SELECT_S positions (a 32 KiB history and two 4,096-position
    tiles of payload): (labels, ml (B, s) int64, dist (B, s) int64, valid
    (B,) int32, data (B, s + L6_ROW_PAD) uint8). Every row has random
    background matches over the whole window; the labelled features sit
    in the payload, at tile (HIST + 4096), 256- and 64-position cell
    edges."""
    import numpy as np

    s, h = SELECT_S, L6_HIST
    rng = np.random.default_rng(seed)
    out = []

    def background():
        ml = rng.choice([0, 0, 0, 4, 5, 6, 8, 12, 20], size=s)
        dist = rng.integers(1, 40, s)
        run = rng.random(s) < 0.6               # same-distance runs
        for t in np.flatnonzero(run[1:]) + 1:
            dist[t] = dist[t - 1]
        return ml.astype(np.int64), dist.astype(np.int64)

    def chain(ml, dist, at, length, d, top=8):
        # a same-distance run as a match finder reports it: lengths
        # capped at `top`, falling to 4 at its end
        t = np.arange(length)
        ml[at:at + length] = np.clip(length + 3 - t, 4, top)
        dist[at:at + length] = d

    def add(label, ml, dist, valid=s):
        ml = np.minimum(ml, np.clip(valid - np.arange(s), 0, 258))
        out.append((label, np.where(ml >= 4, ml, 0), dist, valid))

    ml, dist = background()
    for at, n in ((h + 4096 - 37, 90), (h + 256 - 5, 20), (h + 1024 - 61, 9),
                  (h + 64 * 40 - 3, 300), (h + 4096 * 2 - 40, 40),
                  (h - 20, 50)):
        chain(ml, dist, at, n, 1000 + at % 997)
    add("chains across tile and cell edges", ml, dist)

    ml, dist = background()
    for at, n in ((h + 100, 700), (h + 4096 - 300, 1100), (h + 6000, 520)):
        chain(ml, dist, at, n, 3, top=258)
    add("runs past the 256-byte grid", ml, dist)

    ml, dist = background()
    for k, at in enumerate(range(h + 200, s - 300, 150)):
        ln = (31, 32, 33)[k % 3]
        ml[at - 20:at] = 0                      # nothing covers it
        ml[at] = ln
        dist[at] = 5000 + k
        if k % 4 == 0:                          # a long match close behind
            ml[at + ln // 2] = (33, 32, 31)[k % 3]
            dist[at + ln // 2] = 7000 + k
    add("lengths 31, 32 and 33", ml, dist)

    ml, dist = background()
    cell = h + 4096 + 512
    ml[cell:cell + 256] = 4
    dist[cell:cell + 256] = 100 + np.arange(256) % 2
    add("a cell of 64 four-byte matches", ml, dist)

    ml, dist = background()
    for at in range(h + 11, s - 10, 97):        # demotion: a longer match next
        ml[at], ml[at + 1] = 5, 9
        dist[at], dist[at + 1] = 300, 301
    add("lazy demotion", ml, dist)

    ml, dist = background()
    add("valid_len not a multiple of a cell", ml, dist, valid=h + 5000 + 37)
    ml, dist = background()
    add("valid_len HIST", ml, dist, valid=h)
    ml, dist = background()
    add("valid_len below HIST", ml, dist, valid=h - 100)
    add("one run over the window", np.full(s, 258, np.int64),
        np.ones(s, np.int64))
    add("no matches", np.zeros(s, np.int64), rng.integers(0, 9, s))
    labels = [o[0] for o in out]
    data = rng.integers(0, 256, (len(out), s + L6_ROW_PAD), dtype=np.uint8)
    return (labels, np.stack([o[1] for o in out]),
            np.stack([o[2] for o in out]),
            np.array([o[3] for o in out], np.int32), data)


SELECT_TILE = 3328      # payload positions a tile of csrc/select.cu takes
SELECT_TILE_S = L6_HIST + 4 * SELECT_TILE   # window of the tile-edge arrays


def select_tile_cases(start: int = L6_HIST, seed: int = 17,
                      tile: int = SELECT_TILE):
    """Seeded match-finder outputs at the select kernel's tile edges, in
    windows of SELECT_TILE_S positions with the three tile edges E_k =
    start + k * tile, k = 1..3, of a payload from `start` (L6_HIST for
    the L6 flags, 0 for the others, whose tiles start at 0): (labels, ml
    (B, s) int64, dist (B, s) int64, valid (B,) int32, data (B, s +
    L6_ROW_PAD) uint8), as select_cases gives them. A run "ends" at its
    last member. Each feature sits in a quiet stretch (no background
    match) that keeps it apart from the random background matches."""
    import numpy as np

    s = SELECT_TILE_S
    edge = [start + k * tile for k in (1, 2, 3)]
    rng = np.random.default_rng(seed + start)
    out = []
    dists = iter(range(2000, 30000, 7))     # a distance no other run has

    def background():
        ml = rng.choice([0, 0, 0, 4, 5, 6, 8, 12, 20], size=s)
        dist = rng.integers(1, 40, s)
        run = rng.random(s) < 0.6
        for t in np.flatnonzero(run[1:]) + 1:
            dist[t] = dist[t - 1]
        return ml.astype(np.int64), dist.astype(np.int64)

    def run(ml, dist, first, last, top=258):
        # a same-distance run [first, last] as a match finder reports it
        # (lengths capped at `top`, falling to 4 at its end), with a quiet
        # position on each side
        t = np.arange(last + 1 - first)
        ml[first - 1] = ml[last + 1] = 0
        ml[first:last + 1] = np.clip(last + 4 - first - t, 4, top)
        dist[first:last + 1] = next(dists)

    def one(ml, dist, at, length):
        # a lone match: nothing covers it or chains into or out of it
        ml[at - 1] = ml[at + 1] = 0
        ml[at] = length
        dist[at] = next(dists)

    def add(label, ml, dist, valid=s):
        ml = np.minimum(ml, np.clip(valid - np.arange(s), 0, 258))
        out.append((label, np.where(ml >= 4, ml, 0), dist, valid))

    # chains crossing an edge: capped at 258 all along before E1; capped
    # and short of the cap before E2; at E3, lengths of 4 whose ext at
    # E3 reaches 258 only through the member at E3 + 254
    ml, dist = background()
    run(ml, dist, edge[0] - 40, edge[0] + 259, top=8)
    run(ml, dist, edge[1] - 150, edge[1] + 149, top=8)
    run(ml, dist, edge[2] - 500, edge[2] + 499, top=4)
    add("chains across a tile edge at the 258 cap", ml, dist)

    # the right halo's last member: ext[E] = 258 only from E + 254, and
    # the lazy rule demotes E - 1 (257) because of it
    ml, dist = background()
    for e in edge:
        ml[e - 4:e + 262] = 0
        run(ml, dist, e, e + 254, top=4)
        ml[e - 1], dist[e - 1] = 257, next(dists)
    add("ext at a tile edge from the right halo's end", ml, dist)

    # one run over the whole of tile 1 and into tile 2: the run start
    # crosses a tile whose status holds no boundary
    ml, dist = background()
    run(ml, dist, edge[0] - 1000, edge[1] + 503)
    add("a run over a whole tile", ml, dist)

    ml, dist = background()
    run(ml, dist, edge[0] - 1600, edge[0] - 1)
    run(ml, dist, edge[1] - 1600, edge[1])
    run(ml, dist, edge[2] - 1600, edge[2] - 512)
    add("runs ending at E - 1, E and E - 512", ml, dist)

    ml, dist = background()
    run(ml, dist, edge[0] - 1600, edge[0] - 513)
    run(ml, dist, edge[1] - 1600, edge[1] - 511)
    run(ml, dist, edge[2] - 1600, edge[2] - 2)
    add("runs ending at E - 513, E - 511 and E - 2", ml, dist)

    # long matches whose raw and selected ends cross an edge: at E1 a
    # staircase of raw ends (none of the middle four selected), at E2 a
    # selected match covering E2, at E3 a match at E3 - 255 that the raw
    # end of E3 - 510 keeps unselected, so that E3 is not covered
    ml, dist = background()
    for e in edge:
        ml[e - 600:e + 300] = 0
    for off, length in ((-500, 250), (-260, 200), (-240, 250), (-55, 100),
                        (20, 40), (61, 50)):
        one(ml, dist, edge[0] + off, length)
    one(ml, dist, edge[1] - 100, 200)
    for off, length in ((-510, 256), (-255, 256), (0, 40), (2, 64)):
        one(ml, dist, edge[2] + off, length)
    add("long matches whose ends cross a tile edge", ml, dist)

    ml, dist = background()
    run(ml, dist, edge[0] - 300, edge[0] + 300)
    add("valid_len inside a right halo", ml, dist, valid=edge[0] + 100)

    # lazy-demotion pairs straddling the edges and the halos' ends
    ml, dist = background()
    for e in edge:
        for at in (e - 1, e - 513, e + 255):
            ml[at - 1:at + 3] = 0
            ml[at], ml[at + 1] = 5, 9
            dist[at], dist[at + 1] = next(dists), next(dists)
    add("lazy-demotion pairs across a tile edge", ml, dist)

    labels = [o[0] for o in out]
    data = rng.integers(0, 256, (len(out), s + L6_ROW_PAD), dtype=np.uint8)
    return (labels, np.stack([o[1] for o in out]),
            np.stack([o[2] for o in out]),
            np.array([o[3] for o in out], np.int32), data)


# ----------------------------------------------------------- emit arrays
EMIT_TILE = 2048        # lanes a tile of csrc/emit.cu takes (64 rows)
EMIT_WARP = 256         # lanes a warp of it takes (8 a thread)
EMIT_S = 3 * EMIT_TILE + 96     # three whole tiles and a part
#: nine whole tiles and a part: eight tile edges and a short last tile
EMIT_CHUNK_S = 9 * EMIT_TILE + 96
#: (first column, columns after the lanes) of each lane array's rows in
#: `emit_unaligned`, in the order data, ml, dist, sel, lit: no row of
#: the flags or bytes starts on 16 bytes except by chance, (ml, dist)
#: rows alternate between 8 and 16
EMIT_UNALIGNED = ((3, 7), (1, 2), (3, 0), (5, 6), (11, 2))


def _emit_tables(rng, b, max_len=15):
    """Random litlen and offset tables, int32 `code | len << 16`, lengths
    1..max_len and codes below 2^len."""
    import numpy as np

    out = []
    for n in (288, 30):
        ln = rng.integers(1, max_len + 1, (b, n))
        code = rng.integers(0, 1 << 16, (b, n)) & ((1 << ln) - 1)
        out.append((code | (ln << 16)).astype(np.int32))
    return out


def _greedy_tokens(rng, s, starts, valid, ml_at, dist_at):
    """Greedy tokens of a block of s lanes as the select kernel gives
    them: a match at each of `starts` (its length from ml_at, else
    4..40; its distance from dist_at, else random), literals between
    them, nothing past valid: (ml, dist, sel, lit)."""
    import numpy as np

    ml = np.zeros(s, np.int64)
    dist = rng.integers(1, 32769, s).astype(np.int64)
    sel = np.zeros(s, bool)
    lit = np.zeros(s, bool)
    p = 0
    starts = sorted(set(starts))
    for at in starts + [valid]:
        if at < p:                  # inside the match before it
            continue
        lit[p:min(at, valid)] = True
        if at >= valid:
            break
        ln = int(rng.integers(4, 41)) if ml_at is None else ml_at(at)
        ml[at] = ln
        if dist_at is not None:
            dist[at] = dist_at(at)
        sel[at] = True
        p = at + ln
    ml[~sel] = rng.integers(0, 9, int((~sel).sum()))
    return ml, dist, sel, lit


def emit_cases(seed: int = 19):
    """Seeded emit inputs that hit the emit kernel's traps, as the select
    kernel gives them (a match's next ml - 1 lanes inactive, every other
    lane a literal up to valid_len), in blocks of EMIT_S lanes: (labels,
    data (B, s + L6_ROW_PAD) uint8, ml (B, s) int64, dist (B, s) int64,
    sel (B, s) bool, lit (B, s) bool, ll_tab (B, 288) int32, of_tab (B,
    30) int32, start_bits (B,) int64). Each block starts at another bit
    (0, 1, 3, 5, 7, 31, 77, and past a byte and a word boundary)."""
    import numpy as np

    s = EMIT_S
    rng = np.random.default_rng(seed)
    out = []

    def add(label, starts, valid=s, ml_at=None, dist_at=None):
        out.append((label, *_greedy_tokens(rng, s, starts, valid, ml_at,
                                           dist_at)))

    add("a match on each row's last lane", range(31, s, 64),
        ml_at=lambda at: 4)
    add("a match on a thread's last lane inside a row", range(15, s, 48),
        ml_at=lambda at: 4)
    add("a match on each warp's and tile's last lane and the block's last"
        " lane", [*range(EMIT_WARP - 1, s, EMIT_WARP), s - 1],
        ml_at=lambda at: 4 if at < s - 1 else 1)
    add("literals only, long codes", [])
    add("matches of 257 and 258 at distances 24,577 and 32,768",
        range(5, s - 300, 263), ml_at=lambda at: 257 + at % 2,
        dist_at=lambda at: (24577, 32768)[at % 2])
    add("inactive lanes past valid_len", rng.choice(2000, 60, False),
        valid=2000 + 13)
    add("no tokens", [], valid=0)
    add("random matches", rng.choice(s - 300, 400, False))
    add("random matches, a short block", rng.choice(s - 300, 400, False),
        valid=s - 101)
    b = len(out)
    ll_tab, of_tab = _emit_tables(rng, b)
    long_ll, long_of = _emit_tables(rng, 1, max_len=15)
    long_ll[:] = (long_ll & 0xFFFF) | (15 << 16)
    ll_tab[3], of_tab[3] = long_ll[0], long_of[0]
    data = rng.integers(0, 256, (b, s + L6_ROW_PAD), dtype=np.uint8)
    start = np.array([0, 1, 3, 7, 31, 77, 1029, 65538, 5], np.int64)[:b]
    return ([o[0] for o in out], data,
            *(np.stack([o[k] for o in out]) for k in range(1, 5)),
            ll_tab, of_tab, start)


def emit_random_cases(seed: int = 23, s: int = EMIT_S):
    """Random emit inputs that no selection gives: dense sel and lit
    lanes (a match's offset part riding onto the next lane's own token),
    any length and distance, and random tables with codes of up to 16
    bits and lengths 0..15, so that rows overflow their frames in both
    modes; blocks start at bits 0, 3, 31 and 77. The same tuple as
    emit_cases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = 4
    sel = rng.random((b, s)) < 0.6
    lit = rng.random((b, s)) < 0.5
    ml = rng.integers(0, 259, (b, s)).astype(np.int64)
    dist = rng.integers(0, 32769, (b, s)).astype(np.int64)
    tabs = []
    for n in (288, 30):
        ln = rng.integers(0, 16, (b, n))
        tabs.append((rng.integers(0, 1 << 16, (b, n)) | (ln << 16))
                    .astype(np.int32))
    data = rng.integers(0, 256, (b, s + L6_ROW_PAD), dtype=np.uint8)
    return ([f"random overflowing rows {i}" for i in range(b)], data, ml,
            dist, sel, lit, *tabs, np.array([0, 3, 31, 77], np.int64))


def emit_chunk_cases(seed: int = 31):
    """Seeded emit inputs whose tokens straddle the emit kernel's tile
    edges (every 2,048 lanes) in blocks of EMIT_CHUNK_S lanes, as the
    select kernel gives them: the same tuple as emit_cases. A match's
    offset rides from a tile's last lane into the next tile's first;
    matches cover each edge; a match starts on each tile's first lane;
    the longest codes at the edges; a block that ends inside a short last
    tile; blocks start at bits 0, 5, 31, 4,099 and past 2^20."""
    import numpy as np

    s = EMIT_CHUNK_S
    rng = np.random.default_rng(seed)
    edges = range(EMIT_TILE, s, EMIT_TILE)
    out = [("a match on each tile's last lane, riding into the next tile",
            *_greedy_tokens(rng, s, [e - 1 for e in edges], s,
                            lambda at: 4, None)),
           ("matches of 5 over each tile edge, from 1 to 4 lanes before it",
            *_greedy_tokens(rng, s, [e - 1 - (e // EMIT_TILE) % 4
                                     for e in edges], s, lambda at: 5,
                            None)),
           ("a match on each tile's first lane and each warp's last",
            *_greedy_tokens(rng, s, [*edges, *range(EMIT_WARP - 1, s,
                                                     EMIT_WARP * 3)], s,
                            lambda at: 4, None)),
           ("matches of 258 at distance 32,768 across the edges, long codes",
            *_greedy_tokens(rng, s, [e - 129 for e in edges], s,
                            lambda at: 258, lambda at: 32768)),
           ("random matches, valid_len in the last tile",
            *_greedy_tokens(rng, s, rng.choice(s - 300, 900, False),
                            s - 57, None, None))]
    b = len(out)
    ll_tab, of_tab = _emit_tables(rng, b)
    long_ll, long_of = _emit_tables(rng, 1, max_len=15)
    ll_tab[3] = (long_ll[0] & 0xFFFF) | (15 << 16)
    of_tab[3] = (long_of[0] & 0xFFFF) | (15 << 16)
    data = rng.integers(0, 256, (b, s + L6_ROW_PAD), dtype=np.uint8)
    start = np.array([0, 5, 31, 4099, (1 << 20) + 3], np.int64)
    return ([o[0] for o in out], data,
            *(np.stack([o[k] for o in out]) for k in range(1, 5)),
            ll_tab, of_tab, start)


def emit_unaligned(data, ml, dist, sel, lit):
    """The same lanes as column views of wider rows (EMIT_UNALIGNED), as
    the L1-5 and L6 flows hand over their bytes and distances, but with
    every array's rows off the 16 bytes of the emit kernel's bulk copies:
    tensors of any device, in and out."""
    import torch

    out = []
    for x, (first, after) in zip((data, ml, dist, sel, lit),
                                 EMIT_UNALIGNED, strict=True):
        n = x.shape[1]
        wide = torch.zeros((x.shape[0], first + n + after), dtype=x.dtype,
                           device=x.device)
        wide[:, first:first + n] = x
        out.append(wide[:, first:first + n])
    return tuple(out)


def emit_pass_inputs(datas, level: int, block: int, device):
    """The emit's inputs of one compress pass over these items on
    `device`, as the encode flows form them: at level 1 (the static mode;
    give one item, the tier's pass) ((data, ml, dist, sel, lit, block),
    ()), at 4 or 6 also the tables ((ll_tab, of_tab, hdr_bits)); the L6
    data is its rows' payload columns."""
    import torch
    from libdeflate_rsx_tpu_torch.models import greedy_dynamic as gd
    from libdeflate_rsx_tpu_torch.ops.encode_v2 import static_tokens

    _, arr, valid, hist, finals = gd.split_many(datas, block, level >= 6)
    arr, valid, finals = (torch.from_numpy(x).to(device)
                          for x in (arr, valid, finals))
    if level < 4:
        return (arr, *static_tokens(arr, valid, block), block), ()
    lanes, tables, _, _ = gd.emit_inputs(
        arr, valid, finals, block,
        None if hist is None else torch.from_numpy(hist).to(device))
    return (*lanes, block), tables


# --------------------------------------------- L1-5 match-finder blocks
#: block sizes of the trap set: the cluster's chunk (a quarter of the
#: block) does not divide 1 and 1,021; 100,000 is cut into windows
V2_SIZES = (1, 1021, 1024, 16384, 65536, 100000)
V2_ROW_PAD = 266        # bytes past a block in its row (BLOCK_PAD)


def v2_cases(s: int, seed: int = 29):
    """Seeded blocks of s bytes that hit find_matches_v2's traps:
    (labels, rows (B, s + V2_ROW_PAD) uint8, valid (B,) int32). The
    bytes past each block, and past valid_len where it is short, are
    random and non-zero (the words read them as they are), except in the
    repeated-byte block, whose padding repeats its byte. Traps that need
    room come only at sizes that hold them: w1 differing in byte 0-3 or
    not at all (ml 4-8), the smallest word first or once (the first
    element of the sorted order), distances 32,767-32,769 and a nearest
    copy 32,769 back with an older one further (65,536 and up), and
    matches at the edges of the kernel's windows of a longer block
    (past 65,536). Then the collision traps of the kernel's sort by a
    16-bit hash of the word (`v2_collision_traps`)."""
    import numpy as np

    rng = np.random.default_rng(seed + s)
    text = np.frombuffer(make_corpus("text", s, seed=seed), np.uint8)
    out = []

    def add(label, body, valid=s, tail=None):
        row = np.empty(s + V2_ROW_PAD, np.uint8)
        row[:s] = body[:s]
        row[s:] = rng.integers(1, 256, V2_ROW_PAD) if tail is None else tail
        out.append((label, row, valid))

    def background():
        # no byte 0-15 in it: a planted word starting with 1 is unique
        return rng.integers(16, 256, s, dtype=np.uint8)

    def plant(body, p, d, n=12):
        """A unique word at p - d, its n bytes copied to p."""
        body[p - d] = 1
        body[p - d + 1:p - d + n] = rng.integers(16, 256, n - 1)
        body[p:p + n] = body[p - d:p - d + n]

    add("random", rng.integers(0, 256, s, dtype=np.uint8))
    add("text", text)
    add("periodic 7", np.frombuffer(make_corpus("periodic:7", s, seed=2),
                                    np.uint8))
    add("zeros", np.zeros(s, np.uint8))
    add("one repeated byte", np.full(s, 0x61, np.uint8),
        tail=np.full(V2_ROW_PAD, 0x61, np.uint8))
    for v in range(9):
        add(f"valid_len {v}", text, valid=min(v, s))
    if s >= 64:
        add("short last block", text, valid=s - s // 3 - 5)
        body = rng.integers(1, 256, s, dtype=np.uint8)
        body[:6] = 0
        body[s // 2:s // 2 + 6] = 0
        add("smallest word first", body)
        body = rng.integers(2, 256, s, dtype=np.uint8)
        body[s // 3:s // 3 + 4] = 1
        add("smallest word once", body)
        body = background()
        gap = s // 12
        for j in range(10):
            p = gap + j * gap
            plant(body, p, 8 + (j * 37) % (gap - 20), 8)
            k = j % 5
            if k < 4:                   # w1 differs in byte k
                body[p + 4 + k] ^= 0x5A
        add("w1 differs in byte 0-3 or not at all", body)
    if s >= 65536:
        body = background()
        for d, at in ((32767, 33000), (32768, 40000), (32769, 45000)):
            plant(body, at, d, 40)
        add("distances 32767-32769", body)
        body = background()
        plant(body, 50000, 32769)
        body[50000 - 40000:50000 - 40000 + 12] = body[50000:50000 + 12]
        plant(body, 60000, 20000)
        body[60000 - 30000:60000 - 30000 + 12] = body[60000:60000 + 12]
        add("nearest 32769 back, older further", body)
    if s > 65536:
        # window k of the kernel gives [32768 k, 32768 (k + 1)) and sorts
        # from 32768 (k - 1): matches to the first position of a window,
        # across its start and at its edges
        body = background()
        for p, d in ((65536, 32768), (65536 + 40, 32769), (65500, 32767),
                     (32768 + 20, 32768), (98304 - 30, 1000),
                     (98304 + 12, 32768)):
            plant(body, p, d, 12)
        add("window edges", body)
    v2_collision_traps(s, rng, add, background)
    labels = [o[0] for o in out]
    return (labels, np.stack([o[1] for o in out]),
            np.array([o[2] for o in out], np.int32))


def v2_hashes(row, first: int, n: int):
    """The match kernel's 16-bit hash of the word at each position
    [first, first + n) of a row: (w0 * HASH_MUL mod 2^32) >> 16."""
    import numpy as np
    from libdeflate_rsx_tpu_torch.ops.match_v2 import HASH_MUL

    w = np.asarray(row[first:first + n + 3], np.int64)
    word = w[:n] | w[1:n + 1] << 8 | w[2:n + 2] << 16 | w[3:n + 3] << 24
    return ((word * HASH_MUL) & 0xFFFFFFFF) >> 16


def v2_collider(h: int, low: int) -> bytes:
    """The little-endian word whose hash is h, one for each low 16 bits
    (by the inverse of HASH_MUL mod 2^32): distinct words of one hash."""
    from libdeflate_rsx_tpu_torch.ops.match_v2 import HASH_MUL

    w = (((h << 16) | low) * pow(HASH_MUL, -1, 1 << 32)) & 0xFFFFFFFF
    return w.to_bytes(4, "little")


def v2_collision_traps(s: int, rng, add, background) -> None:
    """Blocks of s bytes for the sort by hash (where they fit), each
    planted on a fresh background (bytes 16-255) at a hash that no other
    position of the block has:
    - a word A, then k distinct words of A's hash 8 bytes apart, a word of
      the hash A's ^ 0x8000 and A again, for k = WALK_CAP - 1 (A's walk
      passes WALK_CAP - 1 runs, then matches), WALK_CAP and WALK_CAP + 1
      (a walk passes the cap: the window takes the sort by the whole
      word; labelled "(escape)"); past 65,536 at 70,000, in two windows;
    - a bucket across the cluster's chunks: words A, B, B, B, C of one
      hash repeated 8 bytes apart (a walk passes a run of B's in one
      step), the hash chosen so that the bucket spans the sorted index
      where the second of 4 blocks (of 8: the third) starts, in the
      block's first window;
    - a colliding run longer than 32,768 (65,536 and up): 20 distinct
      words of one hash every 2,000 bytes from 2,000 to 40,000, A at
      1,000 and 33,769 (32,769 apart: no match) and, past 98,304, at
      66,537 (32,768 after the second: a match)."""
    import numpy as np
    from libdeflate_rsx_tpu_torch.ops.match_v2 import WALK_CAP

    def planted(words, tries=64):
        """body, h: a background with words {position: f(h)} planted at
        the first hash h (drawn from rng) that no other position has."""
        for _ in range(tries):
            h = int(rng.integers(0, 1 << 16))
            body = background()
            for p, make in words.items():
                body[p:p + 4] = np.frombuffer(make(h), np.uint8)
            row = np.concatenate([body, rng.integers(1, 256, 8,
                                                     dtype=np.uint8)])
            mine = sum(v2_hashes(np.frombuffer(make(h), np.uint8), 0, 1)[0]
                       == h for make in words.values())
            if (v2_hashes(row, 0, s) == h).sum() == mine:
                return body
        raise AssertionError("no free hash for a collision trap")

    if s >= 1021:
        base = 70000 if s > 65536 else min(100, s // 4) if s < 16384 \
            else s // 2
        for k in (WALK_CAP - 1, WALK_CAP, WALK_CAP + 1):
            words = {base: lambda h: v2_collider(h, 7)}
            for j in range(1, k + 1):
                words[base + 8 * j] = (lambda j: lambda h:
                                       v2_collider(h, 100 + j))(j)
            words[base + 8 * (k + 1)] = lambda h: v2_collider(h ^ 0x8000, 5)
            words[base + 8 * (k + 2)] = lambda h: v2_collider(h, 7)
            add(f"{k} colliding words between copies"
                + (" (escape)" if k >= WALK_CAP else ""), planted(words))
        # a bucket across the chunks of the first window's sorted list
        n = min(s, 65536)
        chunk = ((n + 3) // 4 + 31) // 32 * 32
        count = min(600, n // 16)
        base = min(5000, n // 8)
        cycle = (1, 2, 2, 2, 3)
        h = chunk * 65536 // n
        for _ in range(40):
            body = background()
            for j in range(count):
                body[base + 8 * j:base + 8 * j + 4] = np.frombuffer(
                    v2_collider(h, cycle[j % 5]), np.uint8)
            row = np.concatenate([body, rng.integers(1, 256, 8,
                                                     dtype=np.uint8)])
            hs = v2_hashes(row, 0, n)
            below, at = int((hs < h).sum()), int((hs == h).sum())
            if at == count and below < chunk < below + at \
                    and abs(chunk - below - count // 2) < count // 4:
                break
            h += max(1, abs(chunk - count // 2 - below) * 65536 // n) \
                * (1 if below < chunk - count // 2 else -1)
        else:
            raise AssertionError("no hash puts the bucket across the chunks")
        add("a bucket across the cluster's chunks", body)
    if s >= 65536:
        words = {1000: lambda h: v2_collider(h, 9),
                 33769: lambda h: v2_collider(h, 9)}
        if s > 98304:
            words[66537] = lambda h: v2_collider(h, 9)
        for j, p in enumerate(range(2000, 40001, 2000)):
            words[p] = (lambda j: lambda h: v2_collider(h, 200 + j))(j)
        add("a colliding run longer than 32768", planted(words))


# -- the device checksums' trap rows and buffers ------------------------------

CHECKSUM_THREADS = 256      # threads a block of csrc/checksums.cu's Adler-32:
                            # thread t takes a tile's 16-byte groups
                            # t + 256 k
CHECKSUM_GROUP = 16         # bytes an Adler group (one dp4a pair a word)
CHECKSUM_NMAX = 5552        # zlib's NMAX: bytes between its mod steps
CHECKSUM_SPAN = 64          # bytes a thread's span of its CRC-32
CHECKSUM_TILE = 65536       # bytes a CRC-32 step (1,024 spans) and an
                            # Adler-32 tile: a wide row's tile
CHECKSUM_BUFFER_ROW = 65536     # bytes a row of one buffer in that kernel
#: row widths: 64 Adler groups, an odd count of 1,024-byte chunks, the main
#: path's 64 KiB blocks
CHECKSUM_WIDTHS = (1024, 5120, 65536)
#: initial values of the buffer traps: 0, 1, and five Adler values whose
#: halves are at or past the modulus 65,521
CHECKSUM_INITS = (0, 1, 0xFFFFFFFF, 0xFFF1FFF1, 0xFFF0FFF0, 0x0000FFFF,
                  0xFFFF0000)


def adler_trap_groups(s: int) -> list[int]:
    """The Adler groups whose edges the trap lengths reach at width s:
    one group of each thread of the tile's (every group where the tile
    has a slot a thread), in the slot (t mod slots) so that every slot
    is reached as well; a thread with no group there takes its first."""
    groups = -(-min(s, CHECKSUM_TILE) // CHECKSUM_GROUP)
    slots = -(-groups // CHECKSUM_THREADS)
    out = []
    for t in range(min(groups, CHECKSUM_THREADS)):
        g = t + CHECKSUM_THREADS * (t % slots)
        out.append(g if g < groups else t)
    return out


def checksum_lengths(s: int) -> list[int]:
    """Row lengths that reach the kernel's edges at width s: 0, 1, 7, 8,
    15, 16 (the bytes around a 16-byte load), the start of one Adler
    group of every thread (adler_trap_groups) and of every CRC span
    (each 64 bytes) and one byte either side (a group the length cuts
    by one byte, or one byte short of the group before it), zlib's NMAX
    (5,552) and its multiples and one byte either side, s - 1 and s."""
    out = {0, 1, 7, 8, 15, 16, s - 1, s}
    for g in adler_trap_groups(s):
        e = g * CHECKSUM_GROUP
        out |= {e - 1, e, e + 1}
    for k in range(1, s // CHECKSUM_NMAX + 1):
        e = k * CHECKSUM_NMAX
        out |= {e - 1, e, e + 1}
    for k in range(1, -(-s // CHECKSUM_SPAN)):
        out |= {k * CHECKSUM_SPAN - 1, k * CHECKSUM_SPAN,
                k * CHECKSUM_SPAN + 1}
    return sorted(x for x in out if 0 <= x <= s)


#: a width of four CRC tiles and one 1,024-byte chunk more
CHECKSUM_WIDE = 4 * CHECKSUM_TILE + 1024


def checksum_wide_rows(seed: int = 43):
    """(rows (B, CHECKSUM_WIDE) uint8, lengths (B,) int64, numpy): rows
    wider than a CRC tile, whose register carries from tile to tile: at
    each tile edge and one byte and one span either side, 0, 1, 63, 65
    and the width; every row zero past its length."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s, t, sp = CHECKSUM_WIDE, CHECKSUM_TILE, CHECKSUM_SPAN
    lens = {0, 1, sp - 1, sp + 1, s - 1, s}
    for k in range(1, 5):
        lens |= {k * t - sp, k * t - 1, k * t, k * t + 1, k * t + sp + 3}
    lens = sorted(x for x in lens if x <= s)
    rows = np.zeros((len(lens), s), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, np.array(lens, np.int64)


def checksum_rows(s: int, seed: int = 31):
    """(rows (B, s) uint8, lengths (B,) int64, numpy): a random row for
    each of checksum_lengths(s), then all-0x00 rows and all-0xFF rows
    at lengths s, s - 1, 17 and 1; every row zero past its length."""
    import numpy as np

    rng = np.random.default_rng(seed + s)
    lens = checksum_lengths(s)
    fills = [None] * len(lens)
    for fill in (0x00, 0xFF):
        lens += [s, s - 1, 17, 1]
        fills += [fill] * 4
    rows = np.zeros((len(lens), s), np.uint8)
    for i, (n, fill) in enumerate(zip(lens, fills)):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8) \
            if fill is None else fill
    return rows, np.array(lens, np.int64)


def checksum_buffers(seed: int = 37) -> list[bytes]:
    """Buffers for the one-buffer path (tiles of 64 KiB, the last one
    short): 1 MiB + 3 random bytes, 1, 16 and 1,023 bytes, one tile
    exactly and a byte either side, three tiles and 1,000 bytes of text,
    zlib's NMAX (5,552) and one byte either side, 12 NMAX + 1 (past a
    tile), and last 70,000 bytes of 0xFF."""
    r = random.Random(seed)
    row, nmax = CHECKSUM_BUFFER_ROW, CHECKSUM_NMAX
    return [r.randbytes((1 << 20) + 3), r.randbytes(1), r.randbytes(16),
            r.randbytes(1023), r.randbytes(row - 1), r.randbytes(row),
            r.randbytes(row + 1), make_corpus("text", 3 * row + 1000, seed),
            r.randbytes(nmax - 1), r.randbytes(nmax), r.randbytes(nmax + 1),
            r.randbytes(12 * nmax + 1), b"\xff" * 70000]


def checksum_ff_rows():
    """(rows (6, 3 tiles) uint8, lengths (6,) int64, numpy): rows of
    0xFF, the Adler kernel's worst case for its 32-bit sums, one, two
    and three tiles long and one byte short of each; zero past the
    length."""
    import numpy as np

    t = CHECKSUM_TILE
    lens = np.array([t, 2 * t, 3 * t, t - 1, 2 * t - 1, 3 * t - 1], np.int64)
    rows = np.zeros((len(lens), 3 * t), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = 0xFF
    return rows, lens


def checksum_odd_stride(s: int = 5120, seed: int = 47):
    """(store (B, s + 1) uint8, lengths (B,) int64, numpy): rows to read
    as the view store[:, :s], whose stride s + 1 is odd, so that each row
    starts at another offset mod 16 (the kernel's single-byte loads):
    the lengths of checksum_lengths(s) thinned to every third, random
    bytes up to each, other random bytes past it (not to be read)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = np.array(checksum_lengths(s)[::3], np.int64)
    store = rng.integers(0, 256, (len(lens), s + 1), dtype=np.uint8)
    return store, lens
