"""Dynamic-Huffman encoder: match finding, symbol histograms, host code
tables and table-coded emission.

Port of `libdeflate_rsx_tpu/ops/encode_dynamic.py`. The flow per batch
of blocks:

  analyze_block     (levels 4-5) find_matches_v2, run extension, greedy
                    selection and per-block litlen/offset histograms
                    (device);
  analyze_block_l6  (levels 6-9) match finding over [32 KiB history |
                    payload], run extension, lazy demotion, greedy
                    selection and the histograms (device);
  build_tables_host histograms -> per-block canonical code tables and
                    serialized headers (host, the package-merge Python
                    builder: the plain version of ops/dyn_tables.py's
                    kernel, which runs this step on the card);
  emit_pack         tokens coded through the tables and bit-packed into
                    row buffers (device: the emit kernel, ops/emit.py).

The JAX functions take one block and are vmapped; these take the batch
dimension first. uint32 values are held in int64.

On the card, analyze_block_l6 runs two kernels: the match finder
(`ops/match_l6.find_matches_l6`, `csrc/match_l6.cu`: a thread block
cluster per window, the window's sorts in its distributed shared
memory), then the selection (`ops/select.select`, `csrc/select.cu`: run
extension, the history mask, lazy demotion, greedy selection and the
histograms, a thread block per window); analyze_block and the level-1
encoder (encode_v2.encode_rows_static) run the selection kernel after
find_matches_v2 (`csrc/match_v2.cu`: a thread block cluster per window
of a block, its positions sorted by word in distributed shared memory,
then one sweep). On the CPU the same functions run the plain versions:
`find_matches_l6_plain` here, `encode_v2.find_matches_v2_plain` and
`select.select_plain` (extend_runs,
select_tokens_l6 or select_tokens, _histograms). In the plain match
finder (as in find_matches_v2)
the JAX package's multi-operand stable sorts become one stable
`torch.sort` on a composed int64 key, with the carried operands gathered
by the returned indices: five sorts (the base tier's word, the 8-byte
grid prefix and the ladder's levels 16, 32 and 64); its sorts on unique
positions (inverse permutations) become scatters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import WINDOW_SIZE
from .encode_v2 import (
    MIN_MATCH,
    _prefix_bytes,
    _unsort,
    _words_at,
    find_matches_v2,
    pack_rows,
    select_tokens,
)
from .static_codes import length_sym_fields, offset_sym_fields

ROW_OUT_DYN = 64      # 32 lanes x <= 15-bit literals = 480 bits = 60 B max
NUM_LITLEN = 288
NUM_OFFSET = 30
_NOSYM_LL = NUM_LITLEN      # histogram discard bin
_NOSYM_OF = NUM_OFFSET

HIST = WINDOW_SIZE          # cross-block history prefix (bytes)
L6_LEVELS = (16, 32, 64)    # rank-ladder candidate levels (bytes)
L6_TIER_K = 6               # predecessors per ladder level
L6_GRID = 2                 # ladder grid stride (bytes)
WTILE_L6 = 256              # selection cell (encode_v2.select_tokens)


def _hist(sym: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row histogram of sym (B, s) over bins 0..nbins-1; the value
    nbins is a discard bin. Returns (B, nbins) int64."""
    b = sym.shape[0]
    rows = torch.arange(b, device=sym.device)[:, None] * (nbins + 1)
    counts = torch.bincount((sym + rows).reshape(-1),
                            minlength=b * (nbins + 1))
    return counts.view(b, nbins + 1)[:, :nbins]


def _ml_from_xors(xs) -> torch.Tensor:
    """Exact common-prefix length 0..4*len(xs) from per-word XORs."""
    total = torch.zeros_like(xs[0])
    alive = torch.ones_like(xs[0], dtype=torch.bool)
    for x in xs:
        step = torch.where(x == 0, 4, _prefix_bytes(x))
        total = total + torch.where(alive, step, 0)
        alive = alive & (x == 0)
    return total


def _merge_cand(ml_new, dist_new, best_ml, best_dist):
    better = (ml_new > best_ml) | ((ml_new == best_ml)
                                   & (dist_new < best_dist) & (ml_new > 0))
    return (torch.where(better, ml_new, best_ml),
            torch.where(better, dist_new, best_dist))


def _shift(a: torch.Tensor, j: int) -> torch.Tensor:
    """a[:, i - j] along dim 1, zero in the first j columns."""
    return torch.cat([torch.zeros_like(a[:, :j]), a[:, :-j]], dim=1)


def check_l6_window(s: int, levels=L6_LEVELS) -> None:
    """Raise ValueError unless find_matches_l6 takes windows of s bytes:
    the covering-decay scan packs (match end << 15 | nearness) into 32
    bits, and match end can reach s + max(levels) + 8; the ladder's grid
    has stride L6_GRID."""
    slack = max(max(levels) + 8, 258)
    if s + slack >= (1 << 17):
        raise ValueError(
            f"find_matches_l6 window {s} too large: HIST + block_size"
            f" + {slack} must stay < {1 << 17} (use block_size <="
            f" {(1 << 17) - HIST - slack - 1})")
    if s % L6_GRID:
        raise ValueError(f"window {s} is not a multiple of {L6_GRID}")


def find_matches_l6_plain(data_padded: torch.Tensor, valid_len: torch.Tensor,
                          hist_start: torch.Tensor, s: int, levels=L6_LEVELS,
                          tier_k: int = L6_TIER_K, k: int = 4):
    """(ml, dist) per position over [history | payload] windows: the
    plain version of the kernel behind ops/match_l6.find_matches_l6.

    data_padded (B, >= s + 71) uint8, valid_len and hist_start (B,).
    Base tier: a stable sort on the 4-byte word with `k` predecessors,
    exact to 16 bytes. Long matches: a prefix-doubling rank ladder on a
    stride-2 grid, `tier_k` predecessors per level, exact to L + 8. A
    covering decay scan spreads candidates to the positions they cover.
    Candidates starting before hist_start are rejected."""
    check_l6_window(s, levels)
    dev = data_padded.device
    d = data_padded.to(torch.int64)
    pos = torch.arange(s, device=dev)
    hs = hist_start.to(torch.int64)[:, None]

    # --- base tier: 4-byte key, k predecessors, exact <= 16
    w0 = _words_at(d, 0, s)
    w0s, poss = torch.sort(w0, dim=1, stable=True)
    wss = [_words_at(d, 4 * (j + 1), s).gather(1, poss) for j in range(3)]
    acc_ml = torch.zeros_like(w0)
    acc_d = torch.zeros_like(w0)
    for j in range(1, k + 1):
        # (the JAX package compares the shifted position vector with j)
        same = (_shift(w0s, j) == w0s) & (_shift(pos[None], j) >= j)
        cand = _shift(poss, j)
        dist = poss - cand
        ok = same & (dist >= 1) & (dist <= WINDOW_SIZE) & (cand >= hs)
        ml = 4 + _ml_from_xors([w ^ _shift(w, j) for w in wss])
        acc_ml, acc_d = _merge_cand(torch.where(ok, ml, 0),
                                    torch.where(ok, dist, 0), acc_ml, acc_d)
    best_ml = _unsort(poss, acc_ml)
    best_dist = _unsort(poss, acc_d)

    # --- prefix-doubling rank ladder (stride-2 grid)
    gs_ = L6_GRID
    m = s // gs_
    gidx = torch.arange(m, device=dev)

    def ahead(r, dd):
        # unique negative tail labels: rank equality past the grid end
        # must never be claimed
        pad = -(torch.arange(dd, device=dev) + 2)
        return torch.cat([r[:, dd:], pad.expand(r.shape[0], dd)], dim=1)

    def rank_of(key_a, key_b, order):
        a, bb = key_a.gather(1, order), key_b.gather(1, order)
        neq = (a != _shift(a, 1)) | (bb != _shift(bb, 1)) | (gidx == 0)
        return a, bb, torch.cumsum(neq.to(torch.int64), dim=1)

    def ladder_pass(key_a, key_b, L):
        # stable sort by (key_a, key_b): key_a >= 1, key_b a signed int32
        _, order = torch.sort(key_a * (1 << 32) + (key_b + (1 << 31)),
                              dim=1, stable=True)
        kas, kbs, rank_sorted = rank_of(key_a, key_b, order)
        c0s = _words_at(d, L, s)[:, ::gs_].gather(1, order)
        c1s = _words_at(d, L + 4, s)[:, ::gs_].gather(1, order)
        t_ml = torch.zeros_like(kas)
        t_d = torch.zeros_like(kas)
        for j in range(1, tier_k + 1):
            same = (_shift(kas, j) == kas) & (_shift(kbs, j) == kbs) \
                & (gidx >= j)
            cand = _shift(order, j) * gs_
            dist = order * gs_ - cand
            ok = same & (dist >= 1) & (dist <= WINDOW_SIZE) & (cand >= hs)
            ml = L + _ml_from_xors([c0s ^ _shift(c0s, j),
                                    c1s ^ _shift(c1s, j)])
            t_ml, t_d = _merge_cand(torch.where(ok, ml, 0),
                                    torch.where(ok, dist, 0), t_ml, t_d)
        return (_unsort(order, rank_sorted), _unsort(order, t_ml),
                _unsort(order, t_d))

    # rank of the 8-byte prefix on the grid: stable sort by the unsigned
    # pair (w0, w4)
    w0g = w0[:, ::gs_]
    w4g = _words_at(d, 4, s)[:, ::gs_]
    _, order8 = torch.sort((w0g - (1 << 31)) * (1 << 32) + w4g, dim=1,
                           stable=True)
    rank = _unsort(order8, rank_of(w0g, w4g, order8)[2])
    half = 8 // gs_
    for L in levels:
        key_b = ahead(rank, half)
        rank, ml_g, dist_g = ladder_pass(rank, key_b, L)
        half = L // gs_
        ml_f = torch.zeros((ml_g.shape[0], m, gs_), dtype=ml_g.dtype,
                           device=dev)
        dist_f = torch.zeros_like(ml_f)
        ml_f[:, :, 0] = ml_g
        dist_f[:, :, 0] = dist_g
        best_ml, best_dist = _merge_cand(ml_f.view(-1, s), dist_f.view(-1, s),
                                         best_ml, best_dist)

    # --- covering decay: spread long candidates to covered positions
    end = torch.where(best_ml >= MIN_MATCH, best_ml + pos, 0)
    packed = (end << 15) | (32768 - best_dist.clamp(1, 32768))
    packed = torch.where(best_ml >= MIN_MATCH, packed, 0)
    cov = torch.cummax(packed, dim=1).values
    cov_ml = (cov >> 15) - pos
    cov_d = 32768 - (cov & 0x7FFF)
    use = (cov_ml > best_ml) & (cov_ml >= MIN_MATCH)
    best_ml = torch.where(use, cov_ml, best_ml)
    best_dist = torch.where(use, cov_d, best_dist)

    best_ml = torch.minimum(
        best_ml, (valid_len.to(torch.int64)[:, None] - pos).clamp(0, 258))
    best_ml = torch.where(best_ml >= MIN_MATCH, best_ml, 0)
    return best_ml, best_dist


def _histograms(byte, ml, dist, sel, lit):
    """Per-block (ll_hist (B, 288), of_hist (B, 30)) uint16 of the
    selected tokens, saturated at 65535."""
    lsym, _, _ = length_sym_fields(torch.clamp(ml, min=MIN_MATCH))
    dsym, _, _ = offset_sym_fields(dist.clamp(1, WINDOW_SIZE))
    hsym = torch.where(sel, lsym, torch.where(lit, byte, _NOSYM_LL))
    ll_hist = _hist(hsym, NUM_LITLEN).clamp(max=65535).to(torch.uint16)
    of_hist = _hist(torch.where(sel, dsym, _NOSYM_OF), NUM_OFFSET) \
        .clamp(max=65535).to(torch.uint16)
    return ll_hist, of_hist


def analyze_block(data_padded: torch.Tensor, valid_len: torch.Tensor,
                  block_size: int):
    """Match pipeline + per-block symbol histograms (levels 4-5).
    data_padded (B, block_size + BLOCK_PAD) uint8, valid_len (B,).

    Returns (ml, dist, sel, lit) (B, block_size), the inputs of
    emit_pack, and (ll_hist (B, 288), of_hist (B, 30)) uint16."""
    from .select import select       # select imports this module

    valid_len = valid_len.to(torch.int64)
    ml, dist = find_matches_v2(data_padded, valid_len, block_size)
    return select(ml, dist, valid_len, data_padded)


def analyze_block_l6(data_padded: torch.Tensor, valid_len: torch.Tensor,
                     hist_start: torch.Tensor, block_size: int):
    """L6 match pipeline over [32 KiB history | payload] + payload-region
    histograms. data_padded (B, HIST + block_size + BLOCK_PAD) uint8;
    valid_len counts history + payload bytes; hist_start is the first
    real history byte (HIST for a stream's first block, 0 after).

    Returns payload-sliced (ml, dist, sel, lit) (B, block_size) and
    (ll_hist (B, 288), of_hist (B, 30)) uint16, saturated at 65535."""
    from .match_l6 import find_matches_l6   # both import this module
    from .select import select

    s = HIST + block_size
    valid_len = valid_len.to(torch.int64)
    ml, dist = find_matches_l6(data_padded, valid_len, hist_start, s)
    return select(ml, dist, valid_len, data_padded, l6=True)


def select_tokens_l6(ml: torch.Tensor, dist: torch.Tensor,
                     valid_len: torch.Tensor):
    """The L6 selection over the whole window, in plain PyTorch (a part
    of select.select_plain): the history region emits nothing (the
    previous block covered it), one-position lazy demotion (the host
    greedy's lazy rule), then select_tokens. Returns (ml, sel, lit)
    (B, s)."""
    pos = torch.arange(ml.shape[1], device=ml.device)
    ml = torch.where(pos >= HIST, ml, 0)
    nxt = torch.cat([ml[:, 1:], torch.zeros_like(ml[:, :1])], dim=1)
    ml = torch.where((nxt > ml) & (ml >= MIN_MATCH) & (nxt >= MIN_MATCH),
                     0, ml)
    return select_tokens(ml, dist, valid_len, wtile=WTILE_L6)


def emit_pack(data_padded: torch.Tensor, ml: torch.Tensor,
              dist: torch.Tensor, sel: torch.Tensor, lit: torch.Tensor,
              ll_tab: torch.Tensor, of_tab: torch.Tensor,
              start_bits: torch.Tensor, block_size: int):
    """Code the selected tokens through per-block tables and bit-pack.

    ll_tab (B, 288) / of_tab (B, 30): entries `code | len << 16` (codes
    bit-reversed for LSB-first emission). start_bits (B,): bit length of
    each block's serialized header. A match's offset part rides the next
    (always covered) lane. Returns pack_rows' (rows, byte_off, row_bit0,
    end_bits). CUDA tensors launch the emit kernel (ops/emit.py), CPU
    tensors run emit_pack_plain."""
    from .emit import emit           # emit imports this module

    return emit(data_padded, ml, dist, sel, lit, block_size, ll_tab, of_tab,
                start_bits)


def emit_pack_plain(data_padded: torch.Tensor, ml: torch.Tensor,
                    dist: torch.Tensor, sel: torch.Tensor, lit: torch.Tensor,
                    ll_tab: torch.Tensor, of_tab: torch.Tensor,
                    start_bits: torch.Tensor, block_size: int):
    """emit_pack in plain PyTorch: the dynamic mode of the emit kernel's
    plain version."""
    s = block_size
    byte = data_padded[:, :s].to(torch.int64)
    ll_tab = ll_tab.to(torch.int64)
    of_tab = of_tab.to(torch.int64)
    lsym, lev, leb = length_sym_fields(torch.clamp(ml, min=MIN_MATCH))
    dsym, dev_, deb = offset_sym_fields(dist.clamp(1, WINDOW_SIZE))

    ent = ll_tab.gather(1, torch.where(sel, lsym, byte))
    code = ent & 0xFFFF
    clen = ent >> 16
    val = code | (torch.where(sel, lev, 0) << clen)
    nb = clen + torch.where(sel, leb, 0)
    active = sel | lit
    val = torch.where(active, val, 0)
    nb = torch.where(active, nb, 0)

    dent = of_tab.gather(1, dsym)
    dcode = dent & 0xFFFF
    dlen = dent >> 16
    dval = torch.where(sel, dcode | (dev_ << dlen), 0)
    dnb = torch.where(sel, dlen + deb, 0)
    zero = torch.zeros_like(val[:, :1])
    val = val | torch.cat([zero, dval[:, :-1]], dim=1)
    nb = nb + torch.cat([zero, dnb[:, :-1]], dim=1)
    return pack_rows(val, nb, start_bits, ROW_OUT_DYN)


def build_tables_host(ll_hist, of_hist, finals: np.ndarray):
    """Histograms -> (ll_tabs (B, 288) u32, of_tabs (B, 30) u32, headers
    list[bytes], hdr_bits (B,) int32), as numpy, per block with the
    Python package-merge builder: the plain version of the table kernel
    (ops/dyn_tables.py). The JAX package's C builder (dyn_tables_c) gives
    other tables than this one, and the JAX package runs this one while
    its C codec does not build. Accepts numpy arrays or tensors."""
    ll_hist, of_hist = (
        (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
        .astype(np.uint32) for x in (ll_hist, of_hist))
    b = ll_hist.shape[0]
    ll_tabs = np.zeros((b, NUM_LITLEN), np.uint32)
    of_tabs = np.zeros((b, NUM_OFFSET), np.uint32)
    headers: list[bytes] = []
    hdr_bits = np.zeros(b, np.int32)
    for i in range(b):
        ll_tabs[i], of_tabs[i], hdr, hdr_bits[i] = _build_tables_py(
            ll_hist[i], of_hist[i], bool(finals[i]))
        headers.append(hdr)
    return ll_tabs, of_tabs, headers, hdr_bits


def _build_tables_py(ll_hist: np.ndarray, of_hist: np.ndarray,
                     final: bool):
    """Pure-Python table builder (the JAX package's fallback for its
    native dyn_tables_c)."""
    from ..models.portable.deflate import (
        TokenStream,
        _dynamic_header_tokens,
        _ensure_complete,
    )
    from ..models.portable.huffman import canonical_codes, make_huffman_code

    llf = ll_hist.astype(np.int64).copy()
    llf[256] += 1
    # litlen limited to 14 bits (native MAX_LL_LEN), offsets to 15
    ll_lens, _ = make_huffman_code(llf, 14)
    of_lens, _ = make_huffman_code(of_hist.astype(np.int64), 15)
    ll_lens = _ensure_complete(ll_lens)
    of_lens = _ensure_complete(of_lens)
    ll_codes = canonical_codes(ll_lens)
    of_codes = canonical_codes(of_lens)
    ts = TokenStream(0)
    ts.put((1 if final else 0) | 0b100, 3)         # BFINAL | BTYPE=10
    values, nbits, _ = _dynamic_header_tokens(ll_lens, of_lens)
    ts.put_arrays(values, nbits)
    hdr = ts.pack()
    bits = ts.bitcount
    ll_tab = ll_codes.astype(np.uint32) | (ll_lens.astype(np.uint32) << 16)
    of_tab = (of_codes[:NUM_OFFSET].astype(np.uint32)
              | (of_lens[:NUM_OFFSET].astype(np.uint32) << 16))
    return ll_tab, of_tab, hdr, bits
