"""LZ token stream format shared by the two-pass device decoder.

The round-3 device decode architecture splits DEFLATE decode into:

- pass 1 (`ops/pallas/inflate_tokens.py`): lockstep-SIMD entropy decode
  of many streams at once across VPU lanes -> one int32 token per lane
  per step;
- pass 2: LZ copy resolution, either the native C resolver
  (`native/codec.c resolve_tokens_c`) or the device lockstep resolver.

This is the TPU re-design of the reference's decode split between the
table-driven symbol loop (reference src/decompress/mod.rs:509-1072) and
the specialized copy kernels (reference src/decompress/x86.rs:2030-2190):
entropy decode is the serial-per-stream part, made throughput-parallel
across streams; copy resolution is the memory-movement part, done at
memcpy speed.

Token format (int32, bits 31 and 29..30 leave bit 31 clear):
    bits 29..30  kind: 0 = NOP (stall/header step), 1 = literal,
                 2 = match
    literal: bits 0..7   the byte
    match:   bits 0..7   length - 3   (DEFLATE lengths 3..258)
             bits 8..22  dist - 1     (DEFLATE distances 1..32768)
"""

from __future__ import annotations

import numpy as np

KIND_NOP = 0
KIND_LIT = 1
KIND_MATCH = 2

KIND_SHIFT = 29


def resolve_tokens_np(tokens: np.ndarray, out_cap: int) -> bytes | None:
    """Reference resolver: token column -> output bytes (None on bad).

    Slow (python loop over match tokens); the oracle for the C and
    device resolvers and the last-resort fallback.
    """
    toks = np.asarray(tokens, np.int32)
    kinds = (toks >> KIND_SHIFT) & 3
    out = np.zeros(out_cap, np.uint8)
    pos = 0
    for t, k in zip(toks.tolist(), kinds.tolist()):
        if k == KIND_NOP:
            continue
        if k == KIND_LIT:
            if pos >= out_cap:
                return None
            out[pos] = t & 0xFF
            pos += 1
            continue
        if k != KIND_MATCH:
            return None
        length = (t & 0xFF) + 3
        dist = ((t >> 8) & 0x7FFF) + 1
        if dist > pos or pos + length > out_cap:
            return None
        if dist >= length:
            out[pos:pos + length] = out[pos - dist:pos - dist + length]
        else:
            for i in range(length):
                out[pos + i] = out[pos - dist + i]
        pos += length
    return out[:pos].tobytes()
