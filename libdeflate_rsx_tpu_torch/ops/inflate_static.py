"""Device decode of stored and static-Huffman streams.

Port of `libdeflate_rsx_tpu/ops/pallas/inflate_static.py`. The Pallas
kernel `_kernel` becomes the CUDA kernel in `csrc/inflate_static.cu`, one
stream per block of one warp, decoding out of shared memory;
`inflate_static_plain` beside it is the plain PyTorch
version of the same function, which decodes all streams of a batch in
lockstep with tensor ops over the batch dimension. `inflate_static`
takes the kernel for a CUDA tensor and the plain version for a CPU
tensor, and nothing else.

Input as `inflate_v2`: `lens (B,)` int32, `words (B, IN_WORDS)` int32
(`inflate_v2.pack`). Output: `out (B, OUT_WORDS)` int32, the decoded
bytes four to a word and at OUT_WORDS-1 the decoded length, or -1 for a
bad stream; bytes past what a stream wrote are 0.

The verdicts are the JAX kernel's, rule for rule. Its bit reader is a
32-bit buffer refilled a byte at a time while it holds at most 24 bits;
past the input's end it reads zero bits, so a static block cut short
ends at the zero code (end-of-block), and a stream that stops without
its final block keeps the bytes it decoded. The static litlen code is
inverted in closed form from 9 peeked bits (symbols 286 and 287 decode
as lengths, as the JAX kernel decodes them); a stored block's LEN must
match ~NLEN and its bytes must lie within the input and OUT_CAP; a
distance beyond the output or a match past OUT_CAP is bad. BTYPE 10 and
11 make the stream bad at once: the JAX kernel first runs the block
through its static decoder, which can write bytes but never changes that
verdict or the count.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .inflate_v2 import IN_CAP, OUT_WORDS, check_inputs, copy_rows, pack

OUT_CAP = (OUT_WORDS - 1) * 4     # data bytes (the count word excluded)

#: kernel launches made by `inflate_static` (the plain version does not
#: count)
LAUNCHES = 0

_HDR, _SYM, _END = range(3)

def _kernel_lib():
    fn = _build.load("inflate_static").ldrsx_inflate_static
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def inflate_static(lens: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Decode a batch of packed stored/static streams: out (B, OUT_WORDS)
    int32 on the inputs' device. CUDA tensors go to the CUDA kernel, CPU
    tensors to `inflate_static_plain`."""
    global LAUNCHES
    check_inputs(lens, words)
    dev = words.device
    if dev.type == "cpu":
        return inflate_static_plain(lens, words)
    fn = _kernel_lib()
    b = lens.shape[0]
    # the kernel writes every word of its rows, zeros and count included
    out = torch.empty((b, OUT_WORDS), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):
        rc = fn(lens.data_ptr(), words.data_ptr(), b, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"inflate_static kernel launch failed: CUDA error {rc} (a "
            "refused shared-memory size or launch, or words not 16-byte "
            "aligned)")
    LAUNCHES += 1
    return out


def inflate_device_static(streams, device="cuda") -> list[bytes | None]:
    """Decode a batch of stored/static DEFLATE streams on `device`.
    Streams over IN_CAP, bad ones, and those with dynamic-Huffman blocks
    yield None, as in the JAX wrapper."""
    if not streams:
        return []
    lens, words = pack(streams, device)
    out = inflate_static(lens, words).cpu().numpy()
    res: list[bytes | None] = []
    for i, s in enumerate(streams):
        n = int(out[i, OUT_WORDS - 1])
        res.append(None if len(s) > IN_CAP or n < 0
                   else out[i].view("<u1")[:n].tobytes())
    return res


# ------------------------------------------------------------ plain version
def inflate_static_plain(lens: torch.Tensor,
                         words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same out words.

    All streams advance in lockstep, one step per loop iteration: a
    block header (with a stored block's copy), or one static symbol with
    its match. The bit buffer is held as the consumed bit position `cp`
    and the refill position `inpos`: the buffer holds the stream's bits
    [cp, 8 * inpos), so it holds 8 * inpos - cp bits (negative once the
    decoder has read zero bits past the end). Runs on any device."""
    check_inputs(lens, words)
    dev = words.device
    i64 = torch.int64
    b = lens.shape[0]
    out = torch.zeros((b, OUT_WORDS * 4), dtype=torch.uint8, device=dev)
    if b == 0:
        return out.view(torch.int32)
    src = words.view(torch.uint8)
    in_len = lens.to(i64)
    k5 = torch.arange(5, device=dev)

    z = torch.zeros(b, dtype=i64, device=dev)
    mode = z + _HDR
    cp, inpos, outpos, bad, final = (z.clone() for _ in range(5))

    def refill():
        nonlocal inpos
        inpos = torch.maximum(inpos, torch.minimum(in_len, (cp + 32) >> 3))

    def peek():             # the buffer's low 32 bits (0 past 8 * inpos)
        idx = ((cp >> 3)[:, None] + k5).clamp(0, IN_CAP - 1)
        g = src.gather(1, idx).to(i64)
        v = ((g << (8 * k5)).sum(1) >> (cp & 7)) & 0xFFFFFFFF
        held = (8 * inpos - cp).clamp(0, 32)
        return v & ((1 << held) - 1)

    def rev(v, n):          # reverse the low n bits
        r = torch.zeros_like(v)
        for k in range(n):
            r = r | (((v >> k) & 1) << (n - 1 - k))
        return r

    while True:
        any_hdr, any_sym = torch.stack(
            [(mode == _HDR).any(), (mode == _SYM).any()]).tolist()
        if not (any_hdr or any_sym):
            break

        if any_hdr:                                     # block header
            mH = mode == _HDR
            stop = mH & ~((inpos < in_len) | (8 * inpos - cp >= 3))
            mode = torch.where(stop, _END, mode)
            mH = mH & ~stop
            refill()
            hdr = peek() & 7
            final = torch.where(mH, hdr & 1, final)
            btype = hdr >> 1
            cp = torch.where(mH, cp + 3, cp)
            mS = mH & (btype == 0)
            if bool(mS.any()):                          # stored block
                cp = torch.where(mS, cp + ((8 * inpos - cp) & 7), cp)
                refill()
                pk = peek()
                ln = pk & 0xFFFF
                start = (cp >> 3) + 4
                bd = (ln != (~(pk >> 16) & 0xFFFF)) \
                    | (start + ln > in_len) | (outpos + ln > OUT_CAP)
                n = torch.where(mS & ~bd, ln, 0)
                rows = (n > 0).nonzero()[:, 0]
                if rows.numel():
                    st = start[rows]
                    copy_rows(out, rows, outpos[rows],
                              lambda kk: src[rows[:, None], st[:, None] + kk],
                              n[rows])
                outpos = outpos + n
                inpos = torch.where(mS, start + n, inpos)
                cp = torch.where(mS, 8 * inpos, cp)
                bad = torch.where(mS, bd.to(i64), bad)
                mode = torch.where(mS, torch.where(bd | (final == 1), _END,
                                                   _HDR), mode)
            mD = mH & (btype >= 2)
            bad = torch.where(mD, 1, bad)
            mode = torch.where(mD, _END, torch.where(mH & (btype == 1), _SYM,
                                                     mode))

        mY = mode == _SYM
        if bool(mY.any()):                              # one static symbol
            refill()
            rev9 = rev(peek() & 0x1FF, 9)
            rev7, rev8 = rev9 >> 2, rev9 >> 1
            is7 = rev7 < 0x18
            is8a = (rev8 >= 0x30) & (rev8 < 0xC0)
            is8b = (rev8 >= 0xC0) & (rev8 < 0xC8)
            sym = torch.where(is7, 256 + rev7, torch.where(
                is8a, rev8 - 0x30, torch.where(is8b, 280 + rev8 - 0xC0,
                                               144 + rev9 - 0x190)))
            used = torch.where(is7, 7, torch.where(is8a | is8b, 8, 9))
            cp = torch.where(mY, cp + used, cp)
            lit = mY & (sym < 256)
            eob = mY & (sym == 256)
            mt = mY & (sym > 256)
            over = lit & (outpos >= OUT_CAP)
            rows = lit.nonzero()[:, 0]
            out[rows, outpos[rows].clamp(max=OUT_CAP - 1)] = \
                sym[rows].to(torch.uint8)
            outpos = torch.where(lit, outpos + 1, outpos)
            bad3 = over
            if bool(mt.any()):
                refill()
                ls = sym - 257
                eb = torch.where((ls < 8) | (ls == 28), 0, (ls - 4) >> 2)
                base = torch.where(ls < 8, ls + 3, torch.where(
                    ls == 28, 258, ((4 + (ls & 3)) << eb) + 3))
                length = base + (peek() & ((1 << eb) - 1))
                cp = torch.where(mt, cp + eb, cp)
                osym = rev(peek() & 0x1F, 5)
                cp = torch.where(mt, cp + 5, cp)
                refill()
                oeb = ((osym >> 1) - 1).clamp(min=0)
                obase = torch.where(osym < 4, osym + 1,
                                    ((2 + (osym & 1)) << oeb) + 1)
                dist = obase + (peek() & ((1 << oeb) - 1))
                cp = torch.where(mt, cp + oeb, cp)
                bm = mt & ((dist > outpos) | (outpos + length > OUT_CAP))
                n = torch.where(mt & ~bm, length, 0)
                rows = (n > 0).nonzero()[:, 0]
                if rows.numel():
                    base_ = (outpos - dist)[rows]
                    dr = dist[rows]
                    copy_rows(out, rows, outpos[rows],
                              lambda kk: out[rows[:, None],
                                             base_[:, None] + kk % dr[:, None]],
                              n[rows])
                outpos = outpos + n
                bad3 = bad3 | bm
            bad = torch.where(bad3, 1, bad)
            mode = torch.where(bad3, _END, torch.where(
                eob, torch.where(final == 1, _END, _HDR), mode))

    res = out.view(torch.int32)
    res[:, OUT_WORDS - 1] = torch.where(bad != 0, -1, outpos).to(torch.int32)
    return res
