"""Batch compression and decompression on a CUDA device.

Port of `libdeflate_rsx_tpu/batch.py`. `BatchCompressor` runs the
device tiers as the JAX package does: level 0 the stored tier
(`models/stored.py`), levels 1-3 the static-Huffman tier
(`models/greedy_static.py`), levels 4-5 the fast dynamic tier and levels
6-9 the L6 ratio tier (`models/greedy_dynamic.py`), whose batched forms
take a whole batch in one pass, or in as few passes as the memory
budget of `budget.py` allows. `BatchDecompressor` routes a device
batch as the JAX package does: fewer than SMALL_BATCH items go to the
small-batch decoder (`ops/inflate_v2.inflate_v2`, one stream per block,
64 KiB caps); larger batches to the two-pass decoder: the pass-1 kernel
(`ops/inflate_tokens.pass1`), then LZ resolution on the device
(`ops/resolve.resolve_batch`) or on the host. Container headers and
checksums are handled on the host. An item the device path cannot take
goes to the host decoder, and each such fallback is counted with its
cause in `BatchDecompressor.fallbacks`.
"""

from __future__ import annotations

import collections

import torch

from . import containers
from .common import MAX_LEVEL, MIN_LEVEL
from .engine import adler32 as adler32_host
from .engine import compress_raw
from .engine import crc32 as crc32_host
from .hostpool import pmap
from .models.portable.deflate import Flush
from .utils.errors import DeflateError, LevelError
from .ops import inflate_tokens, inflate_v2

# levels served by the device encoders; levels 10-12 use the host engine
DEVICE_LEVELS_STORED = {0}
DEVICE_LEVELS_GREEDY = {1, 2, 3}
DEVICE_LEVELS_DYNAMIC = {4, 5, 6, 7, 8, 9}   # 6-9: the L6 ratio tier
MAX_STREAM = 1 << 20     # device decode cap per stream, in and out
MAX_MATCH = 258          # longest DEFLATE match
SMALL_BATCH = 8          # device batches below this go to inflate_v2


def _default_device() -> torch.device:
    """The card: the plain versions run on the CPU only when the caller
    passes device="cpu"."""
    return torch.device("cuda")


class BatchCompressor:
    """Compress many independent buffers at once.

    format: "deflate" | "zlib" | "gzip". use_device=None picks the device
    path when a CUDA device is present, the level has a device tier and
    the tier's output stays within RATIO_SLACK of the host engine's on a
    sample; False forces the host engine. device: where the device tier
    runs (default: cuda)."""

    RATIO_SLACK = 1.05

    def __init__(self, level: int = 6, format: str = "deflate",
                 use_device: bool | None = None, device=None) -> None:
        if not (MIN_LEVEL <= level <= MAX_LEVEL):
            raise LevelError(f"compression level {level} outside 0..=12")
        if format not in ("deflate", "zlib", "gzip"):
            raise ValueError(f"unknown format {format!r}")
        self.level = level
        self.format = format
        self.use_device = use_device
        self.device = torch.device(device) if device is not None \
            else _default_device()
        self._ratio_ok: bool | None = None   # auto-mode calibration cache

    def _frame(self, data: bytes, payload: bytes) -> bytes:
        if self.format == "deflate":
            return payload
        if self.format == "zlib":
            return (containers.zlib_header(self.level) + payload
                    + containers.zlib_footer(adler32_host(data)))
        return (containers.gzip_header(self.level) + payload
                + containers.gzip_footer(crc32_host(data), len(data)))

    def _device_wanted(self) -> bool:
        if self.use_device is False or self.level not in (
                DEVICE_LEVELS_STORED | DEVICE_LEVELS_GREEDY
                | DEVICE_LEVELS_DYNAMIC):
            return False
        if self.use_device:
            return True
        return self.device.type == "cuda" and torch.cuda.is_available()

    def _compress_one_device(self, data: bytes) -> bytes:
        if self.level in DEVICE_LEVELS_STORED:
            from .models.stored import deflate_device_stored as encode
        elif self.level in DEVICE_LEVELS_GREEDY:
            from .models.greedy_static import deflate_device_static as encode
        elif self.level >= 6:
            from .models.greedy_dynamic import deflate_device_l6 as encode
        else:
            from .models.greedy_dynamic import deflate_device_dynamic as encode
        return self._frame(data, encode(data, device=self.device))

    def _compress_many_device(self, items: list[bytes]) -> list[bytes]:
        """The dynamic tiers' batched form: all items' blocks in one
        analyze and one emit pass."""
        if self.level >= 6:
            from .models.greedy_dynamic import deflate_device_l6_many as many
        else:
            from .models.greedy_dynamic import (
                deflate_device_dynamic_many as many)
        payloads = many(items, device=self.device)
        return [self._frame(d, p) for d, p in zip(items, payloads)]

    def _compress_one_host(self, data: bytes) -> bytes:
        return self._frame(data, compress_raw(data, self.level, Flush.FINISH))

    def _compress_item(self, data: bytes) -> bytes:
        try:
            return self._compress_one_host(data)
        except DeflateError:
            return b""

    def _ratio_calibrate(self, items: list[bytes]) -> bool:
        """Auto-mode ratio contract: compress one sample (<= 256 KiB)
        through both paths once per instance and approve the device path
        only if its output stays within RATIO_SLACK of the host
        engine's. A batch of tiny items gets no verdict cached. Level 0
        (stored) is approved without a sample."""
        if self._ratio_ok is not None:
            return self._ratio_ok
        if self.level in DEVICE_LEVELS_STORED:
            self._ratio_ok = True
            return True
        sample = next((x for x in items if len(x) >= 4096), None)
        if sample is None:
            return False
        sample = sample[: 256 << 10]
        dev_size = len(self._compress_one_device(sample))
        host_size = len(self._compress_one_host(sample))
        self._ratio_ok = dev_size <= host_size * self.RATIO_SLACK
        return self._ratio_ok

    def compress_batch(self, inputs) -> list[bytes]:
        """One framed output per input. The dynamic tiers encode a batch
        of several items in one analyze/table/emit pass, the stored and
        static tiers one item at a time; a device failure raises. Host
        items run on the shared thread pool, and a host item that fails
        yields b""."""
        items = [bytes(x) for x in inputs]
        device = self._device_wanted()
        if device and self.use_device is None:
            device = self._ratio_calibrate(items)
        if device:
            if self.level in DEVICE_LEVELS_DYNAMIC and len(items) > 1:
                return self._compress_many_device(items)
            return [self._compress_one_device(d) for d in items]
        return pmap(self._compress_item, items)


class BatchDecompressor:
    """Decompress many independent buffers; failed items yield None.

    use_device=True decodes the raw-DEFLATE payloads on `device`
    (default: cuda). A batch of fewer than SMALL_BATCH
    items goes to the small-batch decoder (64 KiB per stream in, ~64 KiB
    out); a larger one to the two-pass decoder (1 MiB per stream in and
    out), where resolve="device" keeps LZ resolution on the device, so
    only decoded bytes cross to the host, and "host" resolves on the
    host pool. An item that is over the input cap ("in_cap"), that the
    decoder finds bad ("v2" or "pass1") or stops at its output cap
    ("out_cap", or "max_out" when the item's own max_out is within that
    cap), whose resolution fails ("resolve"), that exceeds its max_out
    ("max_out"), or whose container check fails ("container",
    "checksum"), is decoded by the host decoder instead; `fallbacks`
    counts these by cause."""

    def __init__(self, format: str = "deflate", use_device: bool = False,
                 resolve: str = "host", device=None) -> None:
        if format not in ("deflate", "zlib", "gzip"):
            raise ValueError(f"unknown format {format!r}")
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be host|device: {resolve!r}")
        self.format = format
        self.use_device = use_device
        self.resolve = resolve
        self.device = torch.device(device) if device is not None \
            else _default_device()
        self.fallbacks: collections.Counter = collections.Counter()

    def _split_container(self, data: bytes):
        """-> (payload, verify_fn) for the configured format; raises
        DeflateError on a malformed header."""
        if self.format == "deflate":
            return data, lambda out: None
        if self.format == "zlib":
            start = containers.parse_zlib_header(data)

            def verify_zlib(out, data=data):
                containers.verify_zlib_footer(
                    data[len(data) - 4:], adler32_host(out))

            return data[start:len(data) - 4], verify_zlib
        start = containers.parse_gzip_header(data)

        def verify_gzip(out, data=data):
            containers.verify_gzip_footer(
                data[len(data) - 8:], crc32_host(out), len(out))

        return data[start:len(data) - 8], verify_gzip

    def _decompress_batch_device(self, jobs) -> list:
        small = len(jobs) < SMALL_BATCH
        in_cap = inflate_v2.IN_CAP if small else MAX_STREAM
        out: list = [None] * len(jobs)
        causes: dict[int, str] = {}
        idx, payloads, verifies = [], [], []
        for i, (data, cap) in enumerate(jobs):
            try:
                payload, verify = self._split_container(data)
            except DeflateError:
                causes[i] = "container"
                continue
            if len(payload) > in_cap:
                causes[i] = "in_cap"
                continue
            idx.append(i)
            payloads.append(payload)
            verifies.append(verify)
        if idx:
            decode = self._decode_small if small else self._decode_two_pass
            for k, dec in enumerate(decode(jobs, idx, payloads, causes)):
                i = idx[k]
                if i in causes:
                    continue
                if len(dec) > jobs[i][1]:
                    causes[i] = "max_out"
                    continue
                try:
                    verifies[k](dec)
                except DeflateError:
                    causes[i] = "checksum"
                    continue
                out[i] = dec
        for i, cause in sorted(causes.items()):
            self.fallbacks[cause] += 1
            out[i] = self._decompress_item(jobs[i])
        return out

    def _decode_small(self, jobs, idx, payloads, causes) -> list:
        """The small-batch decoder: one inflate_v2 launch. Returns the
        decoded bytes per payload; sets causes[i] where there are none."""
        words = inflate_v2.decode_words(payloads, self.device)
        decoded = []
        for k, i in enumerate(idx):
            dec = inflate_v2.row_bytes(words[k])
            if dec is None:
                causes[i] = "v2"
                if words[k, inflate_v2.OUT_WORDS - 2] & inflate_v2.BAD_OUT_CAP:
                    causes[i] = ("out_cap" if jobs[i][1] > inflate_v2.OUT_CAP
                                 else "max_out")
            decoded.append(dec)
        return decoded

    def _decode_two_pass(self, jobs, idx, payloads, causes) -> list:
        """The two-pass decoder: pass 1 and resolution for the batch, in
        as few device passes as the memory budget (budget.py) allows,
        all at the batch's out_cap. Returns the decoded bytes per
        payload; sets causes[i] where there are none."""
        out_cap = inflate_tokens.cap_bucket(
            [min(jobs[i][1], MAX_STREAM) for i in idx])
        decoded, stats, _ = inflate_tokens.decode_in_passes(
            payloads, out_cap, MAX_STREAM, self.device, self.resolve)
        for k, i in enumerate(idx):
            if stats[k, 0] != inflate_tokens.DONE:
                causes[i] = "pass1"
                if stats[k, 1] > out_cap - MAX_MATCH:
                    # stopped at the batch's out_cap: over the device cap
                    # if the item asked for more, else over its own max_out
                    causes[i] = "out_cap" if jobs[i][1] > out_cap else "max_out"
            elif decoded[k] is None or len(decoded[k]) != stats[k, 1]:
                causes[i] = "resolve"
        return decoded

    def _decompress_one(self, data: bytes, max_out: int) -> bytes:
        from .api import Decompressor
        d = Decompressor()
        if self.format == "deflate":
            return d.decompress_deflate(data, max_out)
        if self.format == "zlib":
            return d.decompress_zlib(data, max_out)
        return d.decompress_gzip(data, max_out)

    def _decompress_item(self, job) -> bytes | None:
        data, cap = job
        try:
            return self._decompress_one(data, cap)
        except DeflateError:
            return None

    def decompress_batch(self, inputs, max_out_sizes) -> list:
        """Per-item fault isolation: a failed item yields None."""
        jobs = [(bytes(d), int(c)) for d, c in zip(inputs, max_out_sizes)]
        if self.use_device and jobs:
            return self._decompress_batch_device(jobs)
        return pmap(self._decompress_item, jobs)
