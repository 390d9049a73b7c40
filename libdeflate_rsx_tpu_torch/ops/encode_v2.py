"""Static-Huffman block encoder: match finding, match extension, greedy
token selection and bit packing.

Port of `libdeflate_rsx_tpu/ops/encode_v2.py`: `find_matches_v2`,
`extend_runs`, `select_tokens`, `pack_rows` and the fused level-1
encoder `encode_rows_static`; the JAX package's host-side row placement
`assemble_blocks` is ops/assemble.py's place_rows. `find_matches_v2`
launches the match kernel (`csrc/match_v2.cu`, ops/match_v2.py) for
CUDA tensors and runs `find_matches_v2_plain` for CPU tensors.
The JAX functions take one block and are vmapped; these take a batch of
blocks, shape (B, s). uint32 values are held in int64. The JAX
package's stable multi-operand sort becomes one stable `torch.sort`
with the carried operands gathered by its indices (an unstable sort
orders ties differently on the card than on the CPU, and so changes the
bytes); its sort by unique position is an inverse permutation, done as
a scatter.
"""

from __future__ import annotations

import torch

from ..common import MAX_MATCH_LEN, WINDOW_SIZE
from . import match_v2
from .static_codes import literal_code, match_token

ROW = 32                  # cover/pack row width (bytes)
ROW_OUT = 48              # row-local output buffer (bytes)
MAX_VEC_ML = 8            # exact verified match length from carried words
MIN_MATCH = 4
BLOCK_PAD = MAX_MATCH_LEN + 8
_NEG = -(1 << 20)

GRID = 256  # run-relative emission grid
TILE = 32   # long-match threshold: matches >= TILE chain on the run grid
WTILE = 64  # short-match walk tile (exact greedy within each cell)
_INF = 1 << 28


def _shift_right(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a[:, i - d] along dim 1, `fill` in the first d columns."""
    pad = torch.full_like(a[:, :d], fill)
    return torch.cat([pad, a[:, :-d]], dim=1)


def _shift_left(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """a[:, i + d] along dim 1, `fill` in the last d columns."""
    pad = torch.full_like(a[:, :d], fill)
    return torch.cat([a[:, d:], pad], dim=1)


def _words_at(d: torch.Tensor, off: int, s: int) -> torch.Tensor:
    """Little-endian 4-byte words at offsets off..off+s-1 of each row of
    d (B, N) int64 bytes."""
    return (d[:, off:off + s] | (d[:, off + 1:off + 1 + s] << 8)
            | (d[:, off + 2:off + 2 + s] << 16)
            | (d[:, off + 3:off + 3 + s] << 24))


def _prefix_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of matching low bytes (0-3) given the XOR of two words."""
    return (((x & 0xFF) == 0).to(torch.int64)
            + ((x & 0xFFFF) == 0).to(torch.int64)
            + ((x & 0xFFFFFF) == 0).to(torch.int64))


def _unsort(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inverse of a sort permutation: out[:, order[:, i]] = vals[:, i]
    (indices unique, so the scatter is deterministic)."""
    return torch.empty_like(vals).scatter_(1, order, vals)


def find_matches_v2(data_padded: torch.Tensor, valid_len: torch.Tensor,
                    block_size: int):
    """find_matches_v2_plain's (ml, dist): one launch of the match kernel
    for CUDA tensors (ops/match_v2.py, no fallback), the plain version
    for CPU tensors; a block size the kernel does not take raises."""
    match_v2.check_v2_block(block_size)
    if data_padded.device.type == "cpu":
        return find_matches_v2_plain(data_padded, valid_len, block_size)
    return match_v2.find_matches_v2_cuda(data_padded, valid_len, block_size)


def find_matches_v2_plain(data_padded: torch.Tensor, valid_len: torch.Tensor,
                          block_size: int):
    """(ml, dist) (B, s) per position: nearest-previous-occurrence
    matches with exact lengths up to MAX_VEC_ML, from one stable sort on
    the 4-byte word at each position carrying the next word.

    data_padded (B, >= s + 7) uint8, valid_len (B,). Lengths beyond 8
    come from extend_runs' same-distance composition."""
    s = block_size
    d = data_padded.to(torch.int64)
    pos = torch.arange(s, device=d.device)
    w0s, poss = torch.sort(_words_at(d, 0, s), dim=1, stable=True)
    w1s = _words_at(d, 4, s).gather(1, poss)
    same = torch.cat([torch.zeros_like(w0s[:, :1], dtype=torch.bool),
                      w0s[:, 1:] == w0s[:, :-1]], dim=1)
    dist = poss - _shift_right(poss, 1, 0)
    ok = same & (dist >= 1) & (dist <= WINDOW_SIZE)
    x1 = w1s ^ _shift_right(w1s, 1, 0)
    ml = 4 + torch.where(x1 == 0, 4, _prefix_bytes(x1))
    ml_u = _unsort(poss, torch.where(ok, ml, 0))
    dist_u = _unsort(poss, torch.where(ok, dist, 0))
    cap = (valid_len.to(torch.int64)[:, None] - pos).clamp(0, MAX_VEC_ML)
    ml_u = torch.minimum(ml_u, cap)
    return torch.where(ml_u >= MIN_MATCH, ml_u, 0), dist_u


def _two_level(x: torch.Tensor) -> torch.Tensor:
    """Inclusive forward prefix max along dim 1 (the JAX package's
    doubling scan of an idempotent op; cummax gives the same values)."""
    return torch.cummax(x, dim=1).values


def extend_runs(ml: torch.Tensor, dist: torch.Tensor,
                valid_len: torch.Tensor) -> torch.Tensor:
    """Extend capped matches through same-distance runs to
    MAX_MATCH_LEN: a segmented reverse max-scan of ml[t] + t, as
    log2(s) doubling steps. ml, dist (B, s); valid_len (B,)."""
    s = ml.shape[1]
    pos = torch.arange(s, device=ml.device)
    nxt_dist = _shift_left(dist, 1, 0)
    nxt_ml = _shift_left(ml, 1, 0)
    matched = ml >= MIN_MATCH
    same = matched & (nxt_ml >= MIN_MATCH) & (nxt_dist == dist)
    v = torch.where(matched, ml + pos, _NEG)
    f = same
    d = 1
    while d < s:
        vs = _shift_left(v, d, _NEG)
        fsh = _shift_left(f, d, False)
        v = torch.maximum(v, torch.where(f, vs, _NEG))
        f = f & fsh
        d *= 2
    ext = torch.minimum(torch.clamp(v - pos, max=MAX_MATCH_LEN),
                        valid_len[:, None] - pos)
    return torch.where(matched, torch.clamp(ext, min=0), 0)


def _tile_rev_min(m: torch.Tensor) -> torch.Tensor:
    """Inclusive reverse prefix min along the last dim."""
    return torch.flip(torch.cummin(torch.flip(m, [-1]), dim=-1).values, [-1])


def select_tokens(ml: torch.Tensor, dist: torch.Tensor,
                  valid_len: torch.Tensor, wtile: int | None = None):
    """Valid non-overlapping token selection (the JAX package's
    run-grid pass for long matches, then an exact greedy walk per
    `wtile` cell for short ones).

    Returns (ml_emit, sel, lit), each (B, s)."""
    W = wtile if wtile is not None else WTILE
    b, s = ml.shape
    dev = ml.device
    pos = torch.arange(s, device=dev)
    in_range = pos < valid_len[:, None]
    matched = (ml >= MIN_MATCH) & in_range

    # --- phase 1: run-grid chained long matches
    prev_m = _shift_right(matched, 1, False)
    prev_d = _shift_right(dist, 1, 0)
    boundary = ~(matched & prev_m & (dist == prev_d))
    run_start = _two_level(torch.where(boundary, pos, -1))
    ml_run = torch.minimum(ml, GRID - ((pos - run_start) % GRID))
    long_ok = matched & (ml_run >= TILE)
    raw_end = torch.where(long_ok, pos + ml_run, 0)
    rawmax_excl = _shift_right(_two_level(raw_end), 1, 0)
    sel1 = long_ok & (rawmax_excl <= pos)
    sel1_end = torch.where(sel1, pos + ml_run, 0)
    selmax_excl = _shift_right(_two_level(sel1_end), 1, 0)
    covered = selmax_excl > pos

    # --- phase 2: exact greedy walk per W cell over the gaps
    nt = s // W
    nxt1 = _tile_rev_min(torch.where(sel1, pos, _INF).view(b, nt, W))
    nxt1_excl = torch.cat([nxt1[:, :, 1:],
                           torch.full_like(nxt1[:, :, :1], _INF)],
                          dim=2).view(b, s)
    ml_short = torch.minimum(ml, W - (pos & (W - 1)))
    ml_short = torch.minimum(ml_short, nxt1_excl - pos)
    short_ok = matched & ~sel1 & ~covered & (ml_short >= MIN_MATCH)

    lane = torch.arange(W, device=dev)
    nxt_t = _tile_rev_min(torch.where(short_ok.view(b, nt, W), lane,
                                      _INF)).clamp(0, W)
    ml_t = ml_short.view(b, nt, W)
    cur = torch.zeros((b, nt), dtype=torch.int64, device=dev)
    visited = torch.zeros((b, nt, W), dtype=torch.bool, device=dev)
    sel2_t = torch.zeros_like(visited)
    # each iteration selects one match per cell: the trip count is
    # bounded by W // MIN_MATCH + 1
    for _ in range(W // MIN_MATCH + 1):
        cand = nxt_t.gather(2, cur.clamp(max=W - 1)[..., None])[..., 0]
        cand = torch.where(cur >= W, W, cand)
        visited |= (lane >= cur[..., None]) & (lane < cand[..., None])
        sel2_t |= lane == cand[..., None]
        ml_at = ml_t.gather(2, cand.clamp(max=W - 1)[..., None])[..., 0]
        cur = torch.where(cand >= W, W, cand + ml_at.clamp(min=0))
    visited = visited.view(b, s)
    sel2 = sel2_t.view(b, s) & short_ok

    lit = visited & in_range & ~covered & ~sel1 & ~sel2
    sel = sel1 | sel2
    ml_emit = torch.where(sel1, ml_run, ml_short)
    return ml_emit, sel, lit


def pack_rows(val: torch.Tensor, nb: torch.Tensor, start_bits: torch.Tensor,
              row_out: int = ROW_OUT):
    """Bit-pack per-lane tokens (val, nb) into globally-aligned row
    buffers, placing each token's bits directly with integer ops.

    val (B, s) holds each lane's bits (< 2^32, no bits at or above its
    nb), nb (B, s) their counts; start_bits (B,) is the global bit offset
    of lane 0. Returns (rows (B, R, row_out + 1) uint8, byte_off (B, R),
    row_bit0 (B, R), end_bits (B,)), the JAX package's layout: rows
    OR-merge into the output at byte_off.
    """
    b, s = val.shape
    if s % ROW:
        raise ValueError(f"block width {s} is not a multiple of {ROW}")
    r = s // ROW
    dev = val.device
    nb = nb.to(torch.int64)
    ends = torch.cumsum(nb, dim=1)
    bitpos = start_bits.to(torch.int64)[:, None] + ends - nb
    bitpos_r = bitpos.view(b, r, ROW)
    # one strided read of the rows' first lanes; the assembly reads the
    # copy, and the (B, s) bit positions can go
    row_bit0 = bitpos_r[:, :, 0].contiguous()
    word_off = row_bit0 >> 5
    local_word = (bitpos_r >> 5) - word_off[..., None]
    shift = bitpos_r & 31
    v = val.to(torch.int64).view(b, r, ROW)
    lo = (v << shift) & 0xFFFFFFFF
    hi = torch.where(shift == 0, 0, v >> (32 - shift))
    # a token occupies words [w, w + 1] of its row; tokens' bits are
    # disjoint, so adding them places them. Words past the row buffer
    # drop into a spare column.
    nw = row_out // 4 + 2
    words = torch.zeros((b, r, nw + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(2, local_word.clamp(max=nw), lo)
    words.scatter_add_(2, (local_word + 1).clamp(max=nw), hi)
    words = words[:, :, :nw]
    bshift = 8 * torch.arange(4, device=dev)
    buf = ((words[..., None] >> bshift) & 0xFF).reshape(b, r, nw * 4)
    buf = buf[:, :, :row_out]
    # rows start mid-byte in general: drop the delta = byte_off -
    # 4 * word_off (in 0..3) leading bytes to align each row globally
    byte_off = row_bit0 >> 3
    delta = byte_off - (word_off << 2)
    bufz = torch.cat([buf, torch.zeros((b, r, 4), dtype=buf.dtype,
                                       device=dev)], dim=2)
    cols = delta[..., None] + torch.arange(row_out + 1, device=dev)
    rows = bufz.gather(2, cols).to(torch.uint8)
    return rows, byte_off, row_bit0, start_bits.to(torch.int64) + ends[:, -1]


def emit_static_plain(data_padded: torch.Tensor, ml: torch.Tensor,
                      dist: torch.Tensor, sel: torch.Tensor,
                      lit: torch.Tensor, block_size: int):
    """The level-1 encoder's coding and packing in plain PyTorch (the
    static mode of the emit kernel's plain version): static literal codes
    and fused match tokens, packed into ROW_OUT rows after the 3-bit
    block header. Returns pack_rows' (rows, byte_off, row_bit0,
    end_bits)."""
    s = block_size
    lv, ln = literal_code(data_padded[:, :s])
    mv, mn = match_token(ml.clamp(min=MIN_MATCH), dist.clamp(1, WINDOW_SIZE))
    val = torch.where(sel, mv, torch.where(lit, lv, 0))
    nb = torch.where(sel, mn, torch.where(lit, ln, 0))

    # the 3-bit block header precedes the body
    start = torch.full((ml.shape[0],), 3, dtype=torch.int64,
                       device=ml.device)
    return pack_rows(val, nb, start, ROW_OUT)


def static_tokens(data_padded: torch.Tensor, valid_len: torch.Tensor,
                  block_size: int):
    """The level-1 tier's tokens of a batch of padded blocks, its emit's
    lanes with data_padded: (ml, dist, sel, lit) from the match finder
    and the select kernel on the card."""
    from .select import select       # select imports this module

    valid_len = valid_len.to(torch.int64)
    ml, dist = find_matches_v2(data_padded, valid_len, block_size)
    ml, _, sel, lit = select(ml, dist, valid_len)
    return ml, dist, sel, lit


def encode_rows_static(data_padded: torch.Tensor, valid_len: torch.Tensor,
                       is_final: torch.Tensor, block_size: int):
    """Level-1 encoder for a batch of padded blocks: matches, greedy
    tokens (the select kernel on the card), static codes and bit packing
    (the emit kernel on the card, ops/emit.py).

    data_padded (B, block_size + BLOCK_PAD) uint8, valid_len and is_final
    (B,). Returns (rows (B, R, ROW_OUT + 1) uint8 globally bit-aligned
    row buffers, byte_off (B, R), rowbits (B, R), total_bits (B,),
    nbytes (B,))."""
    from .emit import emit           # emit imports this module

    rows, byte_off, row_bit0, end_bits = emit(
        data_padded, *static_tokens(data_padded, valid_len, block_size),
        block_size)
    rowbits = torch.diff(torch.cat([row_bit0, end_bits[:, None]], dim=1),
                         dim=1)
    total_bits = end_bits + 7                   # body + EOB (7 zero bits)
    # a non-final block ends in a SYNC: 3-bit header + 00 00 FF FF
    nbytes = torch.where(is_final.to(torch.bool), (total_bits + 7) // 8,
                         (total_bits + 3 + 7) // 8 + 4)
    return rows, byte_off, rowbits, total_bits, nbytes


def deflate_device_static_v2(data: bytes, block_size: int = 65536,
                             device="cuda") -> bytes:
    """Whole-buffer raw-DEFLATE encode on the device (level-1 tier,
    without the stored fallback of models/greedy_static)."""
    from ..models.greedy_static import split_blocks, static_pass
    from .assemble import place_rows, raise_past_cap
    arr, valid, finals, _ = split_blocks(data, block_size)
    inputs = static_pass(arr, valid, finals, block_size, device)
    out, nbytes = place_rows(*inputs[:8], inputs.out_cap)
    raise_past_cap(nbytes.cpu().numpy())
    used = torch.arange(out.shape[1], device=out.device) < nbytes[:, None]
    return out[used].cpu().numpy().tobytes()
