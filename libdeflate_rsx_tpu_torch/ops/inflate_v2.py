"""Small-batch device decoder: whole raw-DEFLATE streams -> bytes.

Port of `libdeflate_rsx_tpu/ops/pallas/inflate_v2.py`. The Pallas kernel
`_kernel` becomes the CUDA kernel in `csrc/inflate_v2.cu`, one stream
per block of one warp, decoding out of shared memory; `inflate_v2_plain` beside it is the plain PyTorch version of
the same function, which decodes all streams of a batch in lockstep with
tensor ops over the batch dimension. `inflate_v2` takes the kernel for a
CUDA tensor and the plain version for a CPU tensor, and nothing else.

Input: `lens (B,)` int32 and `words (B, IN_WORDS)` int32, each stream's
bytes little-endian in its row, zero padded (`pack`). Output: `out (B,
OUT_WORDS)` int32 holding the decoded bytes four to a word, the flag
word at OUT_WORDS-2 (the JAX kernel's cause bits, BAD_*; 0 for a good
stream) and at OUT_WORDS-1 the decoded length, or -1 for a bad stream.
Bytes past what a stream wrote are 0.

Both compute what the JAX kernel computes, rule for rule: BTYPE 00, 01
and 10 with the tables built from each block's header; code-length
symbol 16 repeats the previous length; over-subscribed codes are bad and
incomplete codes decode until an unassigned code is met; a two-level
table whose subtables overflow is bad; a distance beyond the output, a
match past OUT_CAP - 4, output past OUT_CAP, and input past the stream's
end where the JAX kernel checks it, are bad. Bits are read from the
stream's 64 KiB row as a ring, as the JAX kernel reads its words. A
header field that is bad does not stop the header's parse, so the flag
word collects every cause the JAX kernel collects. The JAX kernel keeps
its tables and code lengths in scratch memory that carries over from one
stream to the next; here every stream starts from zeroed tables, which
changes no verdict, count or decoded byte (only the cause bits of a
stream that is bad already can read that state).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .inflate_tokens import (
    CLCL_ORDER,
    _STATIC_LL,
    _STATIC_OF,
    _build_canonical,
    _decode,
    _dist_extra,
    _len_extra,
    _rev15,
    _where_code,
)

IN_WORDS = 16384            # 64 KiB compressed cap per stream
OUT_WORDS = 16384 + 128     # 64 KiB + slack; flags at -2, count at -1
IN_CAP = IN_WORDS * 4
OUT_CAP = (OUT_WORDS - 2) * 4   # data bytes (the trailer words excluded)
LL_WORDS = 4096             # litlen table: 1024-entry root + subtables
OF_WORDS = 2048             # offset table: 256-entry root + subtables
LL_ROOT = 10
OF_ROOT = 8

# cause bits of the flag word, as the JAX kernel sets them
BAD_BTYPE = 1               # BTYPE 11
BAD_STORED_LEN = 2          # LEN != ~NLEN
BAD_STORED_END = 4          # stored bytes past the input or OUT_CAP
BAD_COUNTS = 8              # HLIT > 286 or HDIST > 30
BAD_PRE_END = 16            # precode lengths past the input
BAD_OVERSUB = 32            # an over-subscribed code
BAD_TABLE = 64              # subtables overflow the table
BAD_PRE_CODE = 128          # unassigned precode code
BAD_REPEAT = 256            # repeat with no previous length, or too long
BAD_LENS_COUNT = 512        # code lengths stop short of HLIT + HDIST
BAD_LENS_END = 1024         # code lengths past the input
BAD_NO_EOB = 2048           # end-of-block symbol has no code
BAD_LL_CODE = 4096          # unassigned litlen code, or symbol 286/287
BAD_OF_CODE = 8192          # unassigned offset code
BAD_DIST = 16384            # distance beyond the output
BAD_OUT_CAP = 32768         # output past OUT_CAP
BAD_MATCH_END = 65536       # a match's bits past the input
BAD_BLOCK_END = 131072      # a block ends without end-of-block
BAD_STREAM_END = 262144     # the input ends before the final block

#: kernel launches made by `inflate_v2` (the plain version does not count)
LAUNCHES = 0

_HDR, _RLE, _BODY, _END = range(4)
_MAX_REP = 138


def pack(streams, device="cpu"):
    """Streams -> (lens (B,) int32, words (B, IN_WORDS) int32) on device,
    as the JAX wrapper packs them. A stream over IN_CAP gets length 0
    and zero words."""
    b = len(streams)
    buf = np.zeros((b, IN_CAP), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, s in enumerate(streams):
        if len(s) <= IN_CAP:
            lens[i] = len(s)
            buf[i, :len(s)] = np.frombuffer(s, np.uint8)
    return (torch.from_numpy(lens).to(device),
            torch.from_numpy(buf.view("<i4")).to(device))


def check_inputs(lens: torch.Tensor, words: torch.Tensor) -> None:
    """The rules both stream kernels hold their inputs to."""
    if lens.dtype != torch.int32 or lens.dim() != 1:
        raise ValueError("lens must be a 1-D int32 tensor")
    if words.dtype != torch.int32 or words.shape != (lens.shape[0], IN_WORDS):
        raise ValueError(f"words must be int32 of shape (B, {IN_WORDS})")
    if lens.device != words.device:
        raise ValueError("lens and words must share a device")
    if lens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kernels run on cuda or cpu tensors, not "
                         f"{lens.device}")
    if not (lens.is_contiguous() and words.is_contiguous()):
        raise ValueError("lens and words must be contiguous")
    if lens.numel() and not 0 <= int(lens.min()) <= int(lens.max()) <= IN_CAP:
        raise ValueError(f"lens must lie in 0..{IN_CAP}")


def _kernel_lib():
    fn = _build.load("inflate_v2").ldrsx_inflate_v2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def inflate_v2(lens: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Decode a batch of packed raw-DEFLATE streams: out (B, OUT_WORDS)
    int32 on the inputs' device. CUDA tensors go to the CUDA kernel, CPU
    tensors to `inflate_v2_plain`."""
    global LAUNCHES
    check_inputs(lens, words)
    dev = words.device
    if dev.type == "cpu":
        return inflate_v2_plain(lens, words)
    fn = _kernel_lib()
    b = lens.shape[0]
    # the kernel writes every word of its rows, zeros and trailer included
    out = torch.empty((b, OUT_WORDS), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(lens.data_ptr(), words.data_ptr(), b, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inflate_v2 kernel launch failed: CUDA error {rc}"
                           " (a refused shared-memory size or launch, or "
                           "words not 16-byte aligned)")
    LAUNCHES += 1
    return out


def decode_words(streams, device="cuda") -> np.ndarray:
    """pack + inflate_v2: the output words (B, OUT_WORDS) as numpy."""
    lens, words = pack(streams, device)
    return inflate_v2(lens, words).cpu().numpy()


def row_bytes(row: np.ndarray) -> bytes | None:
    """The decoded bytes of one output row, None for a bad stream."""
    n = int(row[OUT_WORDS - 1])
    return None if n < 0 else row.view("<u1")[:n].tobytes()


def inflate_device(streams, device="cuda") -> list[bytes | None]:
    """Decode a batch of raw-DEFLATE streams (any block types) on
    `device`. An empty stream, one over IN_CAP, or one that fails any
    validity check yields None, as in the JAX wrapper."""
    if not streams:
        return []
    out = decode_words(streams, device)
    return [row_bytes(out[i]) if 0 < len(s) <= IN_CAP else None
            for i, s in enumerate(streams)]


# ------------------------------------------------------------ plain version
def copy_rows(out, rows, dst, get, n) -> None:
    """out[rows[i], dst[i] + k] = get(kk)[i, k] for k < n[i], kk =
    arange(max n): the plain versions' stored and LZ copies. Byte k of
    an LZ copy is byte dst - dist + k % dist, which lies before dst, so
    the copy needs no order."""
    kk = torch.arange(int(n.max()), device=out.device)
    use = kk < n[:, None]
    vals = get(kk)
    r = rows[:, None].expand_as(use)
    out[r[use], (dst[:, None] + kk)[use]] = vals[use]


def _table_overflow(lens, root: int, tab_words: int, ent_zero):
    """(B,) bool: whether the JAX kernel's table fill passes tab_words
    when it runs with the stream already bad. Then it makes no subtable
    pointers, so each code longer than `root` allocates a subtable of
    2**bits, bits taken from its root slot as the fill finds it: the
    entry of the last shorter code (of lower symbol) whose replicas
    cover the slot, else the pre-pass's longest excess at that prefix.
    (A stream not yet bad has a valid code, whose subtables always fit.)
    ent_zero marks symbols whose entries are 0 (litlen 286/287)."""
    b, n = lens.shape
    dev = lens.device
    ls = torch.arange(16, device=dev)
    onehot = lens[:, :, None] == ls
    cnt = onehot.sum(dim=1)
    cnt[:, 0] = 0
    first = [torch.zeros(b, dtype=torch.int64, device=dev)]
    for l in range(1, 16):
        first.append((first[-1] + cnt[:, l - 1]) << 1)
    first = torch.stack(first, dim=1)
    rank = (onehot.cumsum(dim=1) - 1).gather(2, lens[:, :, None])[:, :, 0]
    code = first.gather(1, lens) + rank
    rev = _rev15(code << (15 - lens).clamp(min=0))
    short = (lens > 0) & (lens <= root)
    long = lens > root
    prefix = rev & ((1 << root) - 1)
    submax = torch.zeros((b, 1 << root), dtype=torch.int64, device=dev)
    submax = submax.scatter_reduce(1, prefix, torch.where(long, lens - root, 0),
                                   reduce="amax")
    sym = torch.arange(n, device=dev)
    mask = (1 << lens) - 1
    cover = (short[:, None, :] & (sym[None, :] < sym[:, None])[None]
             & ((prefix[:, :, None] & mask[:, None, :]) == rev[:, None, :]))
    last = ((sym + 1) * cover).max(dim=2).values - 1
    lastc = last.clamp(min=0)
    from_short = torch.where(ent_zero[lastc], 0, lens.gather(1, lastc))
    cur = torch.where(last >= 0, from_short, submax.gather(1, prefix))
    bits = cur.clamp(1, 15 - root)
    total = (1 << root) + torch.where(long, 1 << bits, 0).sum(dim=1)
    return total > tab_words


def inflate_v2_plain(lens: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same out words.

    All streams advance in lockstep, one step per loop iteration: a
    block header (a stored block's copy, or a dynamic header up to its
    precode table, included), one code-length symbol, or one litlen
    symbol with its match. Runs on any device."""
    check_inputs(lens, words)
    dev = words.device
    i64 = torch.int64
    b = lens.shape[0]
    out = torch.zeros((b, OUT_WORDS * 4), dtype=torch.uint8, device=dev)
    if b == 0:
        return out.view(torch.int32)
    src = words.view(torch.uint8)                   # (B, IN_CAP) bytes
    ar = torch.arange(b, device=dev)
    in_len = lens.to(i64)
    in_bits = in_len * 8
    k5 = torch.arange(5, device=dev)
    sh5 = 8 * k5

    def peek(bp):           # 32 bits at bit bp of each row, as a ring
        idx = ((bp >> 3)[..., None] + k5) & (IN_CAP - 1)
        g = src.gather(1, idx.view(b, -1)).view(idx.shape).to(i64)
        return ((g << sh5).sum(-1) >> (bp & 7)) & 0xFFFFFFFF

    z = torch.zeros(b, dtype=i64, device=dev)
    mode = z + _HDR
    bp, op, bad, final, eob = z.clone(), z.clone(), z.clone(), z.clone(), z
    nll, nof, tot, ri = z.clone(), z.clone(), z.clone(), z.clone()
    lensT = torch.zeros((b, 320), dtype=i64, device=dev)
    static_lens = torch.tensor(_STATIC_LL + _STATIC_OF[:30], device=dev)
    s_ll = _build_canonical(static_lens[None, :288], 288)[:3]
    s_of = _build_canonical(static_lens[None, 288:], 32)[:3]
    ll_code = tuple(t.expand(b, -1) for t in s_ll)
    of_code = tuple(t.expand(b, -1) for t in s_of)
    pre_code = _build_canonical(lensT[:, :19], 19)[:3]
    order = torch.tensor(CLCL_ORDER, device=dev)
    k19 = torch.arange(19, device=dev)
    k30 = torch.arange(30, device=dev)
    k288 = torch.arange(288, device=dev)
    krep = torch.arange(_MAX_REP, device=dev)
    ll_zero = k288 >= 286
    of_zero = torch.zeros(30, dtype=torch.bool, device=dev)

    while True:
        any_hdr, any_rle, any_body = torch.stack(
            [(mode == _HDR).any(), (mode == _RLE).any(),
             (mode == _BODY).any()]).tolist()
        if not (any_hdr or any_rle or any_body):
            break

        if any_hdr:                                     # block header
            mH = mode == _HDR
            short = mH & (bp + 3 > in_bits)
            bad = bad | torch.where(short, BAD_STREAM_END, 0)
            mode = torch.where(short, _END, mode)
            mH = mH & ~short
            hdr = peek(bp) & 7
            final = torch.where(mH, hdr & 1, final)
            btype = hdr >> 1
            bp1 = bp + 3
            mS = mH & (btype == 0)
            if bool(mS.any()):                          # stored block
                bps = (bp1 + 7) & ~7
                pk = peek(bps)
                ln = pk & 0xFFFF
                f = torch.where(ln != (~(pk >> 16) & 0xFFFF), BAD_STORED_LEN,
                                0)
                start = (bps + 32) >> 3
                f = f | torch.where((start + ln > in_len) | (op + ln > OUT_CAP),
                                    BAD_STORED_END, 0)
                n = torch.where(mS & (f == 0), ln, 0)
                rows = (n > 0).nonzero()[:, 0]
                if rows.numel():
                    st = start[rows]
                    copy_rows(out, rows, op[rows],
                              lambda kk: src[rows[:, None],
                                             (st[:, None] + kk) & (IN_CAP - 1)],
                              n[rows])
                bp = torch.where(mS, bps + 32 + 8 * n, bp)
                op = op + n
                bad = bad | torch.where(mS, f, 0)
                mode = torch.where(mS, torch.where((f != 0) | (final == 1),
                                                   _END, _HDR), mode)
            mT = mH & (btype == 1)                      # static block
            ll_code = _where_code(mT, s_ll, ll_code)
            of_code = _where_code(mT, s_of, of_code)
            lensT[:, :318] = torch.where(mT[:, None], static_lens, lensT[:, :318])
            m3 = mH & (btype == 3)
            bad = bad | torch.where(m3, BAD_BTYPE | BAD_BLOCK_END, 0)
            mD = mH & (btype == 2)
            if bool(mD.any()):                          # dynamic header
                pk = peek(bp1)
                n_ll = (pk & 31) + 257
                n_of = ((pk >> 5) & 31) + 1
                ne = ((pk >> 10) & 15) + 4
                bpd = bp1 + 14
                f = torch.where((n_ll > 286) | (n_of > 30), BAD_COUNTS, 0)
                v = peek(bpd[:, None] + 3 * k19) & 7
                v = torch.where(k19 < ne[:, None], v, 0)
                pre = torch.zeros((b, 19), dtype=i64, device=dev)
                pre[:, order] = v
                lensT[:, :19] = torch.where(mD[:, None], pre, lensT[:, :19])
                bpd = bpd + 3 * ne
                f = f | torch.where(bpd > in_bits, BAD_PRE_END, 0)
                new = _build_canonical(pre, 19)
                f = f | torch.where(new[3], BAD_OVERSUB, 0)
                pre_code = _where_code(mD, new[:3], pre_code)
                nll = torch.where(mD, n_ll, nll)
                nof = torch.where(mD, n_of, nof)
                tot = nll + nof
                ri = torch.where(mD, 0, ri)
                bad = bad | torch.where(mD, f, 0)
                bp = torch.where(mD, bpd, bp)
            bp = torch.where(mT | m3, bp1, bp)
            eob = torch.where(mT, 0, eob)
            mode = torch.where(mT, _BODY, torch.where(
                m3, _END, torch.where(mD, _RLE, mode)))

        if any_rle or any_hdr:
            mR = mode == _RLE
            go = mR & (ri < tot) & (bad == 0) & (bp <= in_bits)
            fin = mR & ~go
            if bool(go.any()):                          # one code length
                pk = peek(bp)
                sym, lc, badc = _decode(pk, *pre_code, 19)
                sym = torch.where(badc, 0, sym)
                bp2 = bp + torch.where(badc, 0, lc)
                f = torch.where(badc, BAD_PRE_CODE, 0)
                lit = go & (sym <= 15)
                rp = go & (sym > 15)
                is16 = sym == 16
                eb = torch.where(is16, 2, torch.where(sym == 17, 3, 7))
                rep = torch.where(sym == 18, 11, 3) \
                    + (peek(bp2) & ((1 << eb) - 1))
                prev = lensT.gather(1, (ri - 1).clamp(0, 319)[:, None])[:, 0]
                val = torch.where(is16, prev, 0)
                f = f | torch.where(rp & ((is16 & (ri == 0)) | (ri + rep > tot)),
                                    BAD_REPEAT, 0)
                col = (ri[:, None] + krep).clamp(max=319)
                use = ((krep < rep[:, None]) & (rp & (f == 0))[:, None]) \
                    | ((krep == 0) & lit[:, None])
                wval = torch.where(lit, sym, val)[:, None].expand_as(col)
                lensT[ar[:, None].expand_as(col)[use], col[use]] = wval[use]
                ri = torch.where(lit, ri + 1, torch.where(rp, ri + rep, ri))
                bp = torch.where(lit, bp2, torch.where(rp, bp2 + eb, bp))
                bad = bad | torch.where(go, f, 0)
            if bool(fin.any()):                         # tables
                f = torch.where(ri != tot, BAD_LENS_COUNT, 0) \
                    | torch.where(bp > in_bits, BAD_LENS_END, 0)
                ofl = lensT.gather(1, (nll[:, None] + k30).clamp(max=319))
                ofl = torch.where(k30 < nof[:, None], ofl, 0)
                lll = torch.where(k288 >= nll[:, None], 0, lensT[:, :288])
                lensT[:, :318] = torch.where(
                    fin[:, None], torch.cat([lll, ofl], dim=1), lensT[:, :318])
                f = f | torch.where(lensT[:, 256] == 0, BAD_NO_EOB, 0)
                bad = bad | torch.where(fin, f, 0)
                for lo, hi, root, words_, zero in (
                        (0, 288, LL_ROOT, LL_WORDS, ll_zero),
                        (288, 318, OF_ROOT, OF_WORDS, of_zero)):
                    tl = lensT[:, lo:hi]
                    new = _build_canonical(tl, 288 if lo == 0 else 32)
                    bad = bad | torch.where(fin & new[3], BAD_OVERSUB, 0)
                    rows = (fin & (bad != 0)).nonzero()[:, 0]
                    if rows.numel():
                        over = _table_overflow(tl[rows], root, words_, zero)
                        bad[rows] |= torch.where(over, BAD_TABLE, 0)
                    if lo == 0:
                        ll_code = _where_code(fin, new[:3], ll_code)
                    else:
                        of_code = _where_code(fin, new[:3], of_code)
                eob = torch.where(fin, 0, eob)
                mode = torch.where(fin, _BODY, mode)

        mB = mode == _BODY
        go = mB & (eob == 0) & (bad == 0) & (bp <= in_bits)
        ex = mB & ~go
        bad = bad | torch.where(ex & (eob == 0), BAD_BLOCK_END, 0)
        mode = torch.where(ex, torch.where((bad != 0) | (final == 1), _END,
                                           _HDR), mode)
        if bool(go.any()):                              # one litlen symbol
            pk = peek(bp)
            sym, lc, badc = _decode(pk, *ll_code, 288)
            ez = badc | (sym >= 286)
            bp1 = bp + torch.where(ez, 0, lc)
            f = torch.where(ez, BAD_LL_CODE, 0)
            lit = go & ((sym < 256) | ez)
            eobm = go & ~ez & (sym == 256)
            mt = go & ~ez & (sym > 256)
            f = f | torch.where(lit & (op >= OUT_CAP), BAD_OUT_CAP, 0)
            rows = lit.nonzero()[:, 0]
            out[rows, op[rows].clamp(max=OUT_CAP - 1)] = torch.where(
                ez, 0, sym & 255)[rows].to(torch.uint8)
            op = torch.where(lit, op + 1, op)
            eob = torch.where(eobm, 1, eob)
            bp = torch.where(lit | eobm, bp1, bp)
            if bool(mt.any()):
                eb, base = _len_extra(sym)
                length = base + (peek(bp1) & ((1 << eb) - 1))
                bp2 = bp1 + eb
                dsym, dl, dbad = _decode(peek(bp2), *of_code, 32)
                deb, dbase = _dist_extra(dsym)
                deb = torch.where(dbad, 0, deb)
                bp3 = bp2 + torch.where(dbad, 0, dl)
                dist = torch.where(dbad, 0, dbase) \
                    + (peek(bp3) & ((1 << deb) - 1))
                bp4 = bp3 + deb
                f = f | torch.where(mt & dbad, BAD_OF_CODE, 0) \
                    | torch.where(mt & (dist > op), BAD_DIST, 0) \
                    | torch.where(mt & (op + length > OUT_CAP - 4),
                                  BAD_OUT_CAP, 0) \
                    | torch.where(mt & (bp4 > in_bits), BAD_MATCH_END, 0)
                n = torch.where(mt & (f == 0), length, 0)
                rows = (n > 0).nonzero()[:, 0]
                if rows.numel():
                    base_ = (op - dist)[rows]
                    dr = dist[rows]
                    copy_rows(out, rows, op[rows],
                              lambda kk: out[rows[:, None],
                                             base_[:, None] + kk % dr[:, None]],
                              n[rows])
                op = op + n
                bp = torch.where(mt, bp4, bp)
            bad = bad | torch.where(go, f, 0)

    res = out.view(torch.int32)
    res[:, OUT_WORDS - 2] = bad.to(torch.int32)
    res[:, OUT_WORDS - 1] = torch.where(bad != 0, -1, op).to(torch.int32)
    return res
