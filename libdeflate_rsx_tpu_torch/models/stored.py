"""Level-0 tier of the device encoder: stored (uncompressed) DEFLATE blocks.

Port of `libdeflate_rsx_tpu/models/stored.py`: one row per block of at
most 65,535 bytes, its 5-byte header built on the device and spliced in
front of its bytes. Stored blocks are byte-aligned, so the rows
concatenate into one stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import MAX_STORED_BLOCK_LEN

STORED_BLOCK = 65535


def encode_block_stored(data: torch.Tensor, valid_len: torch.Tensor,
                        is_final: torch.Tensor, block_size: int):
    """Encode padded rows data (B, block_size) uint8 as one stored block
    each. valid_len and is_final (B,); block_size must be at most
    MAX_STORED_BLOCK_LEN. Returns (out (B, block_size + 5) uint8, nbytes
    (B,))."""
    if block_size > MAX_STORED_BLOCK_LEN:
        raise ValueError(f"stored block of {block_size} bytes is over "
                         f"{MAX_STORED_BLOCK_LEN}")
    ln = valid_len.to(torch.int64)
    hdr = torch.stack([is_final.to(torch.int64),     # BFINAL, BTYPE=00
                       ln & 0xFF, (ln >> 8) & 0xFF,
                       ~ln & 0xFF, (~ln >> 8) & 0xFF], dim=1)
    out = torch.cat([hdr.to(torch.uint8), data[:, :block_size]], dim=1)
    return out, ln + 5


def deflate_device_stored(data: bytes, block_size: int = STORED_BLOCK,
                          device="cuda") -> bytes:
    """Whole-buffer level-0 raw DEFLATE on the device."""
    n = len(data)
    num = max(1, -(-n // block_size))
    arr = np.zeros((num, block_size), np.uint8)
    valid = np.zeros(num, np.int64)
    flat = np.frombuffer(data, np.uint8)
    for b in range(num):
        lo, hi = b * block_size, min(b * block_size + block_size, n)
        arr[b, : hi - lo] = flat[lo:hi]
        valid[b] = hi - lo
    final = np.zeros(num, bool)
    final[-1] = True
    out, nbytes = encode_block_stored(
        *(torch.from_numpy(x).to(device) for x in (arr, valid, final)),
        block_size)
    out = out.cpu().numpy()
    nbytes = nbytes.cpu().numpy()
    return b"".join(out[b, : int(nbytes[b])].tobytes() for b in range(num))
