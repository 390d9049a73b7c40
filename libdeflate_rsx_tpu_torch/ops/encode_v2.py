"""Match extension, greedy token selection and bit packing (L6 subset).

Port of the parts of `libdeflate_rsx_tpu/ops/encode_v2.py` that the L6
ratio tier runs: `extend_runs`, `_two_level`, `select_tokens` and
`pack_rows`, with their constants. The JAX functions take one block and
are vmapped; these take a batch of blocks, shape (B, s). uint32 values
are held in int64.
"""

from __future__ import annotations

import torch

from ..common import MAX_MATCH_LEN

ROW = 32                  # cover/pack row width (bytes)
ROW_OUT = 48              # row-local output buffer (bytes)
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
    row_bit0 = bitpos_r[:, :, 0]
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
