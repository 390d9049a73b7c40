"""Pass 1 of the two-pass decoder: raw-DEFLATE streams -> LZ tokens.

Port of `libdeflate_rsx_tpu/ops/pallas/inflate_tokens.py`. The Pallas
kernel `_make_kernel` becomes the CUDA kernels in
`csrc/inflate_tokens.cu`. `pass1_plain` beside them is the plain PyTorch
version of the same function: it decodes all streams of a batch in
lockstep with tensor ops over the batch dimension.

`pass1` splits each stream at its sync points and decodes the pieces in
parallel (the segment route):
1. finder (`find_segments`, tensor ops): every byte offset p of a stream
   with bytes p..p+3 == 00 00 FF FF (the LEN/NLEN of an empty stored
   block, which Z_SYNC_FLUSH, Z_FULL_FLUSH and the L6 encoder's SYNC join
   leave between blocks) gives a candidate segment start at bit 8(p+4)
   when p+4 < len; bit 0 always starts one;
2. measure: every candidate is decoded from its bit as a block start. It
   stops at the end of an empty non-final stored block (SYNC), at DONE
   or at BAD, and records its stop bit, its tokens and output length,
   and the largest dist - outpos of its matches, which may reach into
   earlier segments and are not judged there. A stream's first segment
   is the serial decode's own beginning: it judges every match and
   writes its tokens straight into the stream's row; any other segment
   writes its tokens to scratch, as far as its room there goes (a
   quarter of its bits up to the next candidate, plus 16);
3. chain: per stream, from the first segment, follow each SYNC stop bit
   to the candidate that starts there, adding output lengths and token
   counts. The stream is finished when the walk reaches DONE with every
   segment's matches within the output before it and the total within
   out_cap, or when the first segment is BAD (that is the serial
   decode's verdict). Decoding from a true block boundary is exact and
   the walk lands only on true boundaries, so a false candidate (00 00
   FF FF inside stored data or a block body) costs work and never
   changes a result;
4. emit: the later segments of each finished stream are copied from
   scratch to their place in the row; one whose tokens did not fit its
   room is decoded again into its place;
5. rerun: any other stream (a later segment BAD, a failed check, a walk
   that finds no candidate) is decoded serially from bit 0, with sync
   stops off: the serial verdict and stats.
On a CUDA tensor steps 2-5 are the kernels of `csrc/inflate_tokens.cu`;
on a CPU tensor the same orchestration runs in plain PyTorch, with the
segment decode done by `pass1_plain`'s lockstep loop (`_decode_rows`,
rows are segments) and the chain a loop per stream.

Both compute what the JAX kernel computes, not its schedule. Inputs are
one flat uint8 tensor of the concatenated streams, int64 offsets and
int32 lengths; bits past a stream's end read as 0. Outputs are compact
tokens (B, out_cap) int32 in the `ops/tokens.py` format (no NOPs, zeros
after the last token) and stats (B, 4) int32: mode (DONE=6, BAD=7),
output length, bits consumed and token count. There is no step budget:
a well-formed stream within the caps always finishes DONE.

The verdicts are the JAX kernel's, rule for rule, including its step
granularity for the overrun check: a stream whose bit position passes
8*len at the end of a step while still active is BAD. A step is one
header phase (BTYPE, one precode length, or one code-length symbol or
repeat write), one body symbol (with its distance), or one stored byte;
the static block header and the first stored byte share their step with
the first body symbol or byte, and the last code-length symbol shares
its step with the table build and the first body symbol, as in the JAX
kernel when no lane stalls. Code-length symbol 16 repeats the previous
*literal* code length, as the JAX kernel does.

One verdict departs from the JAX kernel's on purpose: a stored byte that
lies at or past a stream's end (or a segment's limit) makes the stream
BAD, in the step that ends the final block too. The JAX kernel moves the
stream to DONE in that step before its overrun check, which judges only
active streams, so it accepts a stream whose final stored block is cut
by one byte, with that byte read as 0; raw DEFLATE has no trailer that
would catch it. Here such a stream falls back to the host, which rejects
it as zlib does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import budget
from . import _build
from .tokens import KIND_LIT, KIND_MATCH, KIND_SHIFT, resolve_tokens_np

# stream modes (active = mode < DONE); a segment stops at SYNC
BLKSTART, PRELEN, LENS, AWAITBUILD, BODY, STORED, DONE, BAD, SYNC = range(9)
STATS = 4           # stats columns: mode, outlen, bits consumed, ntokens
SEG_RES = 5         # segment columns: the stats columns, then max excess

# precode length order (RFC 1951 3.2.7)
CLCL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
              15)

IN_CAP = 65536
MAX_LEN = 1 << 28   # longest stream pass 1 takes, in bytes
OUT_CAP = 65536
_IN_BUCKETS = (65536, 262144, 1048576)
_CAP_BUCKETS = (2048, 16384, 65536, 262144, 1048576)

#: kernel launches made by `pass1`: one per call on a CUDA tensor (the
#: four kernels of the segment route; the plain version does not count)
LAUNCHES = 0
#: the segment route's counts over all `pass1` calls, on either device:
#: segments measured, candidates (other than bit 0) that no chain landed
#: on, streams finished by the chain, streams rerun serially
SEGMENTS = 0
FALSE_CANDIDATES = 0
CONFIRMED = 0
RERUNS = 0

_TOK_LIT = KIND_LIT << KIND_SHIFT
_TOK_MATCH = KIND_MATCH << KIND_SHIFT
_STORED_CHUNK = 4096     # stored bytes per lockstep step in pass1_plain
_STATIC_LL = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
_STATIC_OF = [5] * 32


def in_cap_bucket(streams) -> int:
    """Input-capacity bucket (compressed bytes per stream)."""
    need = max([len(x) for x in streams] or [1])
    for b in _IN_BUCKETS:
        if need <= b:
            return b
    return _IN_BUCKETS[-1]


def cap_bucket(caps) -> int:
    """Output-capacity bucket (decoded bytes per stream)."""
    need = max([c for c in caps] or [1])
    for b in _CAP_BUCKETS:
        if need <= b:
            return b
    return _CAP_BUCKETS[-1]


def pack_streams(streams: list[bytes], in_cap: int = IN_CAP,
                 device="cpu"):
    """Concatenate streams into the pass-1 input layout.

    Returns (data uint8 (total,), offsets int64 (B,), lengths int32 (B,),
    ok list[bool]) with the tensors on `device`. A stream that is empty
    or longer than in_cap is not ok and enters the batch with length 0
    (it decodes as BAD), as in the JAX package."""
    ok = [0 < len(s) <= in_cap for s in streams]
    lens = np.array([len(s) if o else 0 for s, o in zip(streams, ok)],
                    np.int64)
    offs = np.zeros(len(streams), np.int64)
    if len(streams):
        offs[1:] = np.cumsum(lens)[:-1]
    flat = b"".join(s for s, o in zip(streams, ok) if o)
    data = torch.frombuffer(bytearray(flat), dtype=torch.uint8) if flat \
        else torch.zeros(0, dtype=torch.uint8)
    return (data.to(device), torch.from_numpy(offs).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device), ok)


def _check(data, offsets, lengths, out_cap):
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError("data must be a 1-D uint8 tensor")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise ValueError("offsets must be a 1-D int64 tensor")
    if lengths.dtype != torch.int32 or lengths.shape != offsets.shape:
        raise ValueError("lengths must be int32 and shaped like offsets")
    if not (data.device == offsets.device == lengths.device):
        raise ValueError("data, offsets and lengths must share a device")
    if not (data.is_contiguous() and offsets.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("pass-1 inputs must be contiguous")
    if not 0 < out_cap < (1 << 30):
        raise ValueError(f"out_cap {out_cap} out of range")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pass 1 runs on cuda or cpu tensors, not "
                         f"{data.device}")
    if lengths.numel() and int(lengths.max()) >= MAX_LEN:
        raise ValueError(f"streams must be shorter than {MAX_LEN} bytes "
                         f"(stats count their bits in int32)")


def _kernel_lib():
    lib = _build.load("inflate_tokens")
    fn = lib.ldrsx_pass1
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    return fn


def pass1(data: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor,
          out_cap: int, *, _sync_stops: bool = True):
    """Entropy-decode a batch of raw-DEFLATE streams into LZ tokens, by
    the segment route (module docstring).

    CUDA tensors go to the CUDA kernels, CPU tensors to the plain
    versions of the same steps. Returns (tokens (B, out_cap) int32,
    stats (B, 4) int32) on the inputs' device, equal to `pass1_plain`'s.
    `_sync_stops=False` decodes every stream serially from bit 0 with the
    same kernels (one segment per stream), to time the route apart."""
    global LAUNCHES
    _check(data, offsets, lengths, out_cap)
    dev = data.device
    b = offsets.shape[0]
    stats = torch.zeros((b, STATS), dtype=torch.int32, device=dev)
    if b == 0:
        return torch.zeros((0, out_cap), dtype=torch.int32, device=dev), stats
    seg_stream, seg_bit, seg_first = find_segments(data, offsets, lengths,
                                                   _sync_stops)
    room, at = _scratch(lengths, out_cap, seg_stream, seg_bit)
    # the rows, then the segments' scratch, then a trash slot
    tokens = torch.zeros(b * out_cap + int((room + 1).sum()) + 1,
                         dtype=torch.int32, device=dev)
    args = (data, offsets, lengths, out_cap, seg_stream, seg_bit, seg_first,
            room, at + b * out_cap, _sync_stops, tokens, stats)
    if dev.type == "cpu":
        landed, rerun = _segments_plain(*args)
    else:
        landed, rerun = _segments_kernel(*args)
        LAUNCHES += 1
    _count(seg_bit, landed, rerun)
    return tokens[:b * out_cap].view(b, out_cap), stats


def find_segments(data, offsets, lengths, sync_stops: bool = True):
    """Candidate segment starts, in stream order: (stream int64 (S,),
    start bit int64 (S,), first (B+1,) int64: the segments of stream b
    are first[b]..first[b+1]-1, the first of them at bit 0).

    A candidate is a byte offset p of a stream with bytes p..p+3 == 00 00
    FF FF and p+4 < len; it starts at bit 8(p+4). Streams are mapped to
    the flat input by their offsets; where two streams' bytes overlap,
    some of their candidates may be missed, which costs only a serial
    rerun. sync_stops=False gives bit 0 alone."""
    dev = data.device
    i64 = torch.int64
    b = offsets.shape[0]
    streams = [torch.arange(b, device=dev)]
    bits = [torch.zeros(b, dtype=i64, device=dev)]
    if sync_stops and data.numel() >= 4 and b:
        d = data
        hit = (d[:-3] == 0) & (d[1:-2] == 0) & (d[2:-1] == 0xFF) \
            & (d[3:] == 0xFF)
        pos = hit.nonzero().flatten()
        if pos.numel():
            so, order = torch.sort(offsets, stable=True)
            k = torch.searchsorted(so, pos, right=True) - 1
            s = order[k.clamp(min=0)]
            rel = pos - offsets[s]
            keep = (k >= 0) & (rel + 4 < lengths[s].to(i64))
            streams.append(s[keep])
            bits.append(8 * (rel[keep] + 4))
    st, bt = torch.cat(streams), torch.cat(bits)
    order = torch.argsort(st * (1 << 40) + bt)
    st, bt = st[order], bt[order]
    first = torch.searchsorted(st, torch.arange(b + 1, device=dev))
    return st, bt, first


def _scratch(lengths, out_cap, seg_stream, seg_bit):
    """Scratch room (int64 (S,), in tokens) of each segment after the
    first of its stream, and where it starts in the scratch: a quarter of
    the segment's bits up to the next candidate (or the stream's end),
    plus 16, at most out_cap, and one slot more that takes the tokens
    past the room (the kernel stores each token at min(ntok, room)).
    Tokens cost a bit or more each, and the true segments run to the next
    true candidate; one that does not fit is decoded again in the emit
    step."""
    same = torch.zeros_like(seg_bit, dtype=torch.bool)
    same[:-1] = seg_stream[1:] == seg_stream[:-1]
    end = torch.where(same, torch.roll(seg_bit, -1),
                      8 * lengths.to(torch.int64)[seg_stream])
    room = torch.where(seg_bit > 0, ((end - seg_bit) >> 2) + 16, 0)
    room = room.clamp(max=out_cap)
    return room, torch.cumsum(room + 1, 0) - room - 1


def _count(seg_bit, landed, rerun) -> None:
    global SEGMENTS, FALSE_CANDIDATES, CONFIRMED, RERUNS
    false, reruns = torch.stack([((seg_bit > 0) & (landed == 0)).sum(),
                                 rerun.sum()]).tolist()
    SEGMENTS += seg_bit.numel()
    FALSE_CANDIDATES += false
    RERUNS += reruns
    CONFIRMED += rerun.numel() - reruns


def _segments_kernel(data, offsets, lengths, out_cap, seg_stream, seg_bit,
                     seg_first, room, at, sync_stops, tokens, stats):
    """Steps 2-5 of the segment route on the card: one call of the C
    entry, which launches the measure, chain, emit and rerun kernels.
    tokens is flat: the rows, then the scratch (segment i's room[i]
    tokens from at[i]), then a trash slot. Fills tokens and stats;
    returns (landed (S,), rerun (B,)) int32."""
    fn = _kernel_lib()
    dev = data.device
    b, nseg = offsets.shape[0], seg_bit.numel()
    seg_res = torch.empty((nseg, SEG_RES), dtype=torch.int32, device=dev)
    seg_base = torch.full((nseg,), -1, dtype=torch.int32, device=dev)
    landed = torch.zeros(nseg, dtype=torch.int32, device=dev)
    rerun = torch.zeros(b, dtype=torch.int32, device=dev)
    room = room.to(torch.int32)
    with torch.cuda.device(dev):
        rc = fn(data.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), b,
                out_cap, seg_stream.data_ptr(), seg_bit.data_ptr(),
                seg_first.data_ptr(), room.data_ptr(),
                at.data_ptr(), nseg, int(sync_stops),
                seg_res.data_ptr(), seg_base.data_ptr(), landed.data_ptr(),
                rerun.data_ptr(), tokens.data_ptr(), stats.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inflate_tokens kernel launch failed: "
                           f"CUDA error {rc}")
    return landed, rerun


def _segments_plain(data, offsets, lengths, out_cap, seg_stream, seg_bit,
                    seg_first, room, at, sync_stops, tokens, stats):
    """Steps 2-5 of the segment route in plain PyTorch: what
    `_segments_kernel` computes."""
    first = seg_bit == 0
    res = _decode_rows(data, offsets, lengths, out_cap, seg_stream, seg_bit,
                       sync_stops, first, tokens,
                       torch.where(first, seg_stream * out_cap, at),
                       torch.where(first, out_cap, room))
    fin, base, landed, rerun = _chain(res.numpy(), seg_bit.numpy(),
                                      seg_first.numpy(), out_cap)
    stats.copy_(torch.from_numpy(fin))
    base = torch.from_numpy(base).to(torch.int64)
    rerun = torch.from_numpy(rerun)
    emit = (base >= 0) & (rerun[seg_stream] == 0)
    ntok = res[:, 3]
    dest = seg_stream * out_cap + base
    copy = (emit & (ntok <= room)).nonzero().flatten()
    if copy.numel():                  # from scratch to the segments' places
        n = ntok[copy]
        k = torch.arange(int(n.sum())) - torch.repeat_interleave(
            torch.cumsum(n, 0) - n, n)
        tokens[torch.repeat_interleave(dest[copy], n) + k] = \
            tokens[torch.repeat_interleave(at[copy], n) + k]
    again = (emit & (ntok > room)).nonzero().flatten()
    if again.numel():                 # past their room: decoded again
        _decode_rows(data, offsets, lengths, out_cap, seg_stream[again],
                     seg_bit[again], True, again < 0, tokens, dest[again],
                     torch.full_like(again, out_cap))
    again = rerun.nonzero().flatten()
    if again.numel():
        z = torch.zeros_like(again)
        res = _decode_rows(data, offsets, lengths, out_cap, again, z, False,
                           z == 0, tokens, again * out_cap, z + out_cap)
        stats[again] = res[:, :STATS].to(torch.int32)
    return torch.from_numpy(landed), rerun


def _chain(res, seg_bit, seg_first, out_cap):
    """The chain of step 3 per stream, in numpy: (stats (B, 4) int32,
    token base per segment int32 (-1: not emitted), landed (S,) int32,
    rerun (B,) int32). The stats of a rerun stream are left zero."""
    b = len(seg_first) - 1
    stats = np.zeros((b, STATS), np.int32)
    base = np.full(len(seg_bit), -1, np.int32)
    landed = np.zeros(len(seg_bit), np.int32)
    rerun = np.ones(b, np.int32)
    for s in range(b):
        i, last = int(seg_first[s]), int(seg_first[s + 1])
        pout = ptok = 0
        while True:
            landed[i] = 1
            mode, outlen, bits, ntok, excess = (int(v) for v in res[i])
            if mode == BAD:
                if i == seg_first[s]:        # the serial decode's verdict
                    stats[s] = res[i, :STATS]
                    rerun[s] = 0
                break
            if excess > pout or pout + outlen > out_cap:
                break
            if i != seg_first[s]:
                base[i] = ptok
            pout += outlen
            ptok += ntok
            if mode == DONE:
                stats[s] = (DONE, pout, bits, ptok)
                rerun[s] = 0
                break
            j = i + 1 + int(np.searchsorted(seg_bit[i + 1:last], bits))
            if j >= last or seg_bit[j] != bits:
                break
            i = j
    return stats, base, landed, rerun


# ------------------------------------------------------------ plain version
def _rev15(x):
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _build_canonical(lens, nperm):
    """Canonical-code tables from code lengths, per row.

    lens (B, nsym) int64 in 0..15 -> (lim (B, 16), fb (B, 16),
    perm (B, nperm), over-subscribed (B,)). lim rows are MSB-aligned
    15-bit limits (row 0 unused), fb = base index - first code, perm the
    symbols sorted by (length, symbol) and zero past the coded ones."""
    b, nsym = lens.shape
    dev = lens.device
    ls = torch.arange(16, device=dev)
    cnt = (lens[:, :, None] == ls).sum(dim=1)
    cnt[:, 0] = 0
    kraft = (cnt[:, 1:] << (15 - ls[1:])).sum(dim=1)
    code = torch.zeros(b, dtype=torch.int64, device=dev)
    bidx = torch.zeros_like(code)
    lim = [torch.full_like(code, 1 << 29)]
    fb = [torch.zeros_like(code)]
    for l in range(1, 16):
        lim.append((code + cnt[:, l]) << (15 - l))
        fb.append(bidx - code)
        code = (code + cnt[:, l]) << 1
        bidx = bidx + cnt[:, l]
    syms = torch.arange(nsym, device=dev)
    key = torch.where(lens > 0, lens * 512 + syms, 16 * 512 + syms)
    order = torch.sort(key, dim=1).indices
    coded = torch.arange(nsym, device=dev) < bidx[:, None]
    perm = torch.zeros((b, nperm), dtype=torch.int64, device=dev)
    perm[:, :nsym] = torch.where(coded, order, 0)
    return (torch.stack(lim, 1), torch.stack(fb, 1), perm,
            kraft > (1 << 15))


def _decode(pk, lim, fb, perm, nperm):
    """One canonical decode per row from the low 15 peeked bits:
    (symbol, code length clipped to 1..15, undecodable)."""
    v15 = _rev15(pk & 0x7FFF)
    length = 1 + (v15[:, None] >= lim[:, 1:16]).sum(dim=1)
    lc = length.clamp(1, 15)
    off = (v15 >> (15 - lc)) + fb.gather(1, lc[:, None])[:, 0]
    sym = perm.gather(1, off.clamp(0, nperm - 1)[:, None])[:, 0]
    return sym, lc, length >= 16


def _len_extra(sym):
    ls = sym - 257
    eb = torch.where(ls < 8, 0, torch.where(ls == 28, 0, (ls >> 2) - 1))
    base = torch.where(ls < 8, ls + 3,
                       torch.where(ls == 28, 258, ((4 + (ls & 3)) << eb) + 3))
    return eb, base


def _dist_extra(dsym):
    deb = ((dsym >> 1) - 1).clamp(min=0)
    dbase = torch.where(dsym < 4, dsym + 1, ((2 + (dsym & 1)) << deb) + 1)
    return deb, dbase


def _where_rows(mask, new, old):
    return torch.where(mask[:, None], new, old)


def _where_code(mask, new, old):
    """Per-row select of a code's (lim, fb, perm) tables."""
    return tuple(_where_rows(mask, n, o) for n, o in zip(new, old))


def _put(t, col, mask, val):
    """t[b, col[b]] = val[b] for the rows b in mask (out of place)."""
    c = col[:, None]
    cur = t.gather(1, c)[:, 0]
    return t.scatter(1, c, torch.where(mask, val, cur)[:, None])


def pass1_plain(data: torch.Tensor, offsets: torch.Tensor,
                lengths: torch.Tensor, out_cap: int):
    """Plain PyTorch pass 1: the same (tokens, stats) as `pass1`.

    Every stream is decoded serially from bit 0: all streams advance in
    lockstep, one step per loop iteration (see the module docstring for
    what a step is); stored bytes advance up to _STORED_CHUNK steps at
    once, with the per-step checks applied byte by byte. Runs on the CPU
    or the card."""
    _check(data, offsets, lengths, out_cap)
    dev = data.device
    b = offsets.shape[0]
    tokens = torch.zeros(b * out_cap + 1, dtype=torch.int32, device=dev)
    z = torch.zeros(b, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)
    res = _decode_rows(data, offsets, lengths, out_cap, rows, z, False,
                       z == 0, tokens, rows * out_cap, z + out_cap)
    return (tokens[:b * out_cap].view(b, out_cap),
            res[:, :STATS].to(torch.int32))


def _decode_rows(data, offsets, lengths, out_cap, row_stream, start_bit,
                 sync_stop: bool, strict, tokens, tok_at, tok_room):
    """The plain segment decoder: row r decodes stream row_stream[r] from
    bit start_bit[r] as a block start, in lockstep with the other rows.

    sync_stop: a row stops (SYNC) at the end of an empty non-final stored
    block. strict (R,) bool: a match reaching before the row's own output
    is BAD; otherwise it is kept and its reach counted in the excess
    column. The row's tokens go to the flat tensor `tokens` (its last
    slot a trash slot) from index tok_at[r], as many as tok_room[r]
    holds. Returns (R, SEG_RES) int64: mode (DONE, BAD or SYNC),
    output length, bits consumed (counted from the stream's bit 0), token
    count and the largest dist - outpos of the row's matches (0 if
    none)."""
    dev = data.device
    i64 = torch.int64
    b = row_stream.shape[0]
    if b == 0:
        return torch.zeros((0, SEG_RES), dtype=i64, device=dev)
    src = torch.cat([data.to(i64), torch.zeros(1, dtype=i64, device=dev)])
    nsrc = src.numel()
    off = offsets.to(i64)[row_stream]
    ln = lengths.to(i64)[row_stream]
    inbits = ln * 8
    order = torch.tensor(CLCL_ORDER, dtype=i64, device=dev)

    def byte_at(idx):       # (B, k) byte indices -> bytes, 0 past the end
        inb = (idx >= 0) & (idx < ln[:, None])
        g = src[(off[:, None] + idx).clamp(0, nsrc - 1)]
        return torch.where(inb, g, 0)

    # 40-bit little-endian window at every byte of the flat input
    win = src.clone()
    for k in range(1, 5):
        win[:-k] |= src[k:] << (8 * k)

    def peek(bitpos):       # 32 bits of each stream from bitpos
        byte = bitpos >> 3
        nvalid = (ln - byte).clamp(0, 5)
        v = win[(off + byte).clamp(0, nsrc - 1)] & ((1 << (8 * nvalid)) - 1)
        return (v >> (bitpos & 7)) & 0xFFFFFFFF

    trash = tokens.numel() - 1
    z = torch.zeros(b, dtype=i64, device=dev)
    mode, final, outpos, srem = z.clone(), z.clone(), z.clone(), z.clone()
    nlit, ndist, hclen, idx = z.clone(), z.clone(), z.clone(), z.clone()
    prev, rep, repval = z - 1, z.clone(), z.clone()
    ntok, excess = z.clone(), z.clone()
    bitpos = start_bit.to(i64).clone()

    def emit(mask, tok):
        nonlocal ntok
        where = torch.where(mask & (ntok < tok_room), tok_at + ntok, trash)
        tokens[where] = tok.to(torch.int32)
        ntok = ntok + mask.to(i64)

    ll_lens = torch.zeros((b, 288), dtype=i64, device=dev)
    of_lens = torch.zeros((b, 32), dtype=i64, device=dev)
    pre_lens = torch.zeros((b, 19), dtype=i64, device=dev)
    s_ll = _build_canonical(torch.tensor([_STATIC_LL], device=dev), 288)
    s_of = _build_canonical(torch.tensor([_STATIC_OF], device=dev), 32)
    ll_code = tuple(t.expand(b, -1) for t in s_ll[:3])    # (lim, fb, perm)
    of_code = tuple(t.expand(b, -1) for t in s_of[:3])
    pre_code = _build_canonical(pre_lens, 19)[:3]
    kchunk = torch.arange(_STORED_CHUNK, device=dev)

    while True:
        mode0 = mode
        flags = torch.stack([(mode0 < DONE).any(), (mode0 == BLKSTART).any(),
                             (mode0 == PRELEN).any(), (mode0 == LENS).any(),
                             (mode0 == BODY).any(),
                             (mode0 == STORED).any()]).tolist()
        any_act, any_blk, any_pre, any_lens, any_body, any_stored = flags
        if not any_act:
            break
        sync_hit = None

        if any_blk:                              # block header
            mS = mode0 == BLKSTART
            pk = peek(bitpos)
            final = torch.where(mS, pk & 1, final)
            btype = (pk >> 1) & 3
            bp = bitpos + torch.where(mS, 3, 0)
            bad = mS & (btype == 3)
            mSt = mS & (btype == 0)
            bp = bp + torch.where(mSt, (8 - (bp & 7)) & 7, 0)
            pk2 = peek(bp)
            slen = pk2 & 0xFFFF
            bad = bad | (mSt & (slen != (((pk2 >> 16) & 0xFFFF) ^ 0xFFFF)))
            bp = bp + torch.where(mSt, 32, 0)
            srem = torch.where(mSt, slen, srem)
            mStat = mS & (btype == 1)
            ll_code = _where_code(mStat, s_ll, ll_code)
            of_code = _where_code(mStat, s_of, of_code)
            mDyn = mS & (btype == 2)
            nlit = torch.where(mDyn, 257 + ((pk >> 3) & 31), nlit)
            ndist = torch.where(mDyn, 1 + ((pk >> 8) & 31), ndist)
            hclen = torch.where(mDyn, 4 + ((pk >> 13) & 15), hclen)
            bp = bp + torch.where(mDyn, 14, 0)
            bad = bad | (mDyn & ((nlit > 286) | (ndist > 30)))
            idx = torch.where(mDyn, 0, idx)
            prev = torch.where(mDyn, -1, prev)
            rep = torch.where(mDyn, 0, rep)
            ll_lens = _where_rows(mDyn, 0, ll_lens)
            of_lens = _where_rows(mDyn, 0, of_lens)
            pre_lens = _where_rows(mDyn, 0, pre_lens)
            after = torch.where(final == 1, DONE, BLKSTART)
            mode = torch.where(mSt, torch.where(slen > 0, STORED, after), mode)
            if sync_stop:        # an empty non-final stored block ends here
                sync_hit = mSt & (slen == 0) & (final == 0)
            mode = torch.where(mStat, BODY, mode)
            mode = torch.where(mDyn, PRELEN, mode)
            mode = torch.where(bad, BAD, mode)
            bitpos = bp

        if any_pre:                              # one precode length
            mP = mode0 == PRELEN
            pk = peek(bitpos)
            pre_lens = _put(pre_lens, order[idx.clamp(0, 18)], mP, pk & 7)
            bitpos = bitpos + torch.where(mP, 3, 0)
            idx = torch.where(mP, idx + 1, idx)
            mPd = mP & (idx >= hclen)
            if bool(mPd.any()):
                new = _build_canonical(pre_lens, 19)
                pre_code = _where_code(mPd, new, pre_code)
                mode = torch.where(mPd, torch.where(new[3], BAD, LENS), mode)
                idx = torch.where(mPd, 0, idx)

        if any_lens:                             # one code-length step
            mL = mode0 == LENS
            drain = mL & (rep > 0)
            dec = mL & ~drain
            pk = peek(bitpos)
            sym, clen, badc = _decode(pk, *pre_code, 19)
            e16 = dec & (sym == 16)
            e17 = dec & (sym == 17)
            e18 = dec & (sym == 18)
            elit = dec & (sym <= 15)
            rbits = torch.where(e16, 2, torch.where(e17, 3,
                                                    torch.where(e18, 7, 0)))
            rv = (pk >> clen) & ((1 << rbits) - 1)
            bitpos = bitpos + torch.where(dec, clen + rbits, 0)
            newrep = torch.where(e16 | e17, 3 + rv,
                                 torch.where(e18, 11 + rv, 0))
            repval = torch.where(e16, prev,
                                 torch.where(e17 | e18, 0, repval))
            bad = (dec & badc) | (e16 & (prev < 0)) \
                | (dec & ~elit & (idx + newrep > nlit + ndist))
            wval = torch.where(elit, sym, repval)
            wmask = elit | drain
            ll_lens = _put(ll_lens, idx.clamp(0, 287), wmask & (idx < nlit),
                           wval)
            of_lens = _put(of_lens, (idx - nlit).clamp(0, 31),
                           wmask & (idx >= nlit), wval)
            idx = torch.where(wmask, idx + 1, idx)
            rep = torch.where(drain, rep - 1, torch.where(dec, newrep, rep))
            prev = torch.where(elit, sym, prev)
            mW = mL & (idx >= nlit + ndist) & ~bad
            mode = torch.where(bad, BAD, mode)
            if bool(mW.any()):                   # table build
                new_ll = _build_canonical(ll_lens, 288)
                new_of = _build_canonical(of_lens[:, :30], 32)
                ll_code = _where_code(mW, new_ll, ll_code)
                of_code = _where_code(mW, new_of, of_code)
                over = new_ll[3] | new_of[3]
                mode = torch.where(mW, torch.where(over, BAD, BODY), mode)

        # one body symbol (and its distance) per BODY stream
        if any_body or any_blk or any_lens:
            mB = mode == BODY
            pk = peek(bitpos)
            sym, clen, badc = _decode(pk, *ll_code, 288)
            is_lit = mB & (sym < 256)
            is_eob = mB & (sym == 256)
            is_len = mB & (sym > 256)
            eb, lbase = _len_extra(sym)
            length = lbase + ((pk >> clen) & ((1 << eb) - 1))
            bitpos = bitpos + torch.where(mB, clen, 0) \
                + torch.where(is_len, eb, 0)
            badb = mB & (badc | (sym > 285))
            badb = badb | (is_lit & (outpos + 1 > out_cap))
            wlit = is_lit & ~badb
            emit(wlit, _TOK_LIT | sym)
            outpos = outpos + wlit.to(i64)
            mode = torch.where(is_eob, torch.where(final == 1, DONE, BLKSTART),
                               mode)
            mode = torch.where(badb, BAD, mode)
            mM = is_len & ~badb
            if bool(mM.any()):
                pk = peek(bitpos)
                dsym, dlen, dbadc = _decode(pk, *of_code, 32)
                deb, dbase = _dist_extra(dsym)
                dist = dbase + ((pk >> dlen) & ((1 << deb) - 1))
                bitpos = bitpos + torch.where(mM, dlen + deb, 0)
                badd = mM & (dbadc | (dsym > 29) | (strict & (dist > outpos))
                             | (outpos + length > out_cap))
                wm = mM & ~badd
                excess = torch.where(wm, torch.maximum(excess, dist - outpos),
                                     excess)
                emit(wm, _TOK_MATCH | (length - 3) | ((dist - 1) << 8))
                outpos = torch.where(wm, outpos + length, outpos)
                mode = torch.where(badd, BAD, mode)

        if any_stored or (any_blk and bool((mode == STORED).any())):
            # stored bytes, up to _STORED_CHUNK steps at once
            mV = mode == STORED
            n = torch.clamp(srem, max=_STORED_CHUNK)
            i_cap = out_cap - outpos
            q = inbits - bitpos
            i_over = torch.where(q >= 0, q >> 3, 0)
            by_cap = (i_cap < n) & (i_cap <= i_over)
            by_over = ~by_cap & (i_over < n)
            nemit = torch.where(by_cap, i_cap,
                                torch.where(by_over, i_over + 1, n))
            nuse = torch.where(by_cap, i_cap + 1, nemit)
            nemit = torch.where(mV, nemit, 0)
            nuse = torch.where(mV, nuse, 0)
            em = (kchunk < nemit[:, None]) \
                & (ntok[:, None] + kchunk < tok_room[:, None])
            byts = byte_at((bitpos >> 3)[:, None] + kchunk)
            where = torch.where(em, (tok_at + ntok)[:, None] + kchunk, trash)
            tokens[where] = (_TOK_LIT | byts).to(torch.int32)
            ntok = ntok + nemit
            outpos = outpos + nemit
            bitpos = bitpos + 8 * nuse
            srem = srem - nuse
            stop = mV & (by_cap | by_over)
            after = torch.where(final == 1, DONE, BLKSTART)
            mode = torch.where(mV & (srem == 0), after, mode)
            mode = torch.where(stop, BAD, mode)

        # consumed past the stream end while still active -> malformed
        mode = torch.where((mode < DONE) & (bitpos > inbits), BAD, mode)
        if sync_hit is not None:
            mode = torch.where(sync_hit & (mode == BLKSTART), SYNC, mode)

    return torch.stack([mode, outpos, bitpos, ntok, excess], dim=1)


# ------------------------------------------------------------ batch wrappers
def decode_streams(streams: list[bytes], out_cap: int = OUT_CAP,
                   in_cap: int | None = None, device="cuda"):
    """Pack streams and run pass 1 on `device`.

    Returns (tokens (B, out_cap) int32 on device, stats (B, 4) int32
    numpy, ok list[bool]); a stream that is not ok never decodes."""
    if in_cap is None:
        in_cap = in_cap_bucket(streams)
    data, offsets, lengths, ok = pack_streams(streams, in_cap, device)
    tokens, stats = pass1(data, offsets, lengths, out_cap)
    return tokens, stats.cpu().numpy(), ok


def resolve_streams(tokens, stats, out_cap: int, where: str = "device"):
    """Pass 2 for every stream of a pass-1 batch, whatever its mode:
    list[bytes | None], None where resolution fails. where="device"
    resolves on the tokens' device (only bytes cross to the host), each
    column read up to its stream's token count; "host" with the numpy
    resolver on the host pool."""
    from ..hostpool import pmap
    from .resolve import resolve_batch

    n = stats.shape[0]
    ntok = max(1, int(stats[:, 3].max()))
    if where == "device":
        counts = torch.from_numpy(np.ascontiguousarray(stats[:, 3]))
        out, outlen, ok = resolve_batch(tokens[:, :ntok], out_cap,
                                        counts.to(tokens.device))
        out_h = out[:, :max(1, int(stats[:, 1].max()))].cpu().numpy()
        len_h = outlen.cpu().numpy()
        ok_h = ok.cpu().numpy()
        return [out_h[i, :len_h[i]].tobytes() if ok_h[i] else None
                for i in range(n)]
    toks = tokens[:, :ntok].cpu().numpy()
    return pmap(lambda job: resolve_tokens_np(*job),
                [(toks[i, :stats[i, 3]], int(stats[i, 1])) for i in range(n)])


def decode_in_passes(streams: list[bytes], out_cap: int = OUT_CAP,
                     in_cap: int | None = None, device="cuda",
                     where: str = "device"):
    """Pass 1 and resolution (`resolve_streams`) of `streams` in as few
    device passes as the memory budget (budget.py) allows, split at
    streams, all at this out_cap and in_cap: (decoded list[bytes |
    None], stats (B, 4) int32 numpy, ok list[bool]). A stream is as
    decoded in one pass."""
    if in_cap is None:
        in_cap = in_cap_bucket(streams)
    got, stats, oks = [], [np.zeros((0, STATS), np.int32)], []
    sizes = [max(out_cap, len(s)) for s in streams]
    for lo, hi in budget.passes("decode", sizes, device):
        tokens, st, ok = decode_streams(streams[lo:hi], out_cap, in_cap,
                                        device)
        got += resolve_streams(tokens, st, out_cap, where)
        del tokens
        stats.append(st)
        oks += ok
    return got, np.concatenate(stats), oks


def _finished(streams, out_cap, in_cap, device, where):
    got, stats, ok = decode_in_passes(streams, out_cap, in_cap, device,
                                      where)
    return [g if ok[i] and stats[i, 0] == DONE and g is not None
            and len(g) == stats[i, 1] else None for i, g in enumerate(got)]


def decode_tokens_device(streams: list[bytes], out_cap: int = OUT_CAP,
                         in_cap: int | None = None, device="cuda"):
    """Pass 1: raw-DEFLATE streams -> per-stream (token column int32
    numpy array | None, expected outlen). Streams over the input cap or
    not DONE give (None, 0)."""
    if not streams:
        return []
    tokens, stats, ok = decode_streams(streams, out_cap, in_cap, device)
    toks = tokens[:, :max(1, int(stats[:, 3].max()))].cpu().numpy()
    return [(toks[i, :stats[i, 3]].copy(), int(stats[i, 1]))
            if ok[i] and stats[i, 0] == DONE else (None, 0)
            for i in range(len(streams))]


def inflate_device_tokens(streams: list[bytes], out_cap: int = OUT_CAP,
                          in_cap: int | None = None, device="cuda"):
    """Two-pass decode, pass 2 on the host. Returns list[bytes | None]."""
    return _finished(streams, out_cap, in_cap, device, "host")


def inflate_device_fused(streams: list[bytes], out_cap: int = OUT_CAP,
                         in_cap: int | None = None, device="cuda"):
    """Two-pass decode with both passes on `device`: the tokens never
    leave it, only decoded bytes do. Returns list[bytes | None]."""
    return _finished(streams, out_cap, in_cap, device, "device")
