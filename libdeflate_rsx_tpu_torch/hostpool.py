"""Host thread pool for the port's per-item host work.

A copy of `pmap` from `libdeflate_rsx_tpu/parallel/hostpool.py` (the
port imports nothing of the JAX package). The host engine's chunked
compress over 256 KiB, the stream encoder's flushes and the batch
classes' host items run on it.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

_PREFIX = "ldrsx-torch"
_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None


def pool_width() -> int:
    """Worker count: LIBDEFLATE_RSX_THREADS env var or os.cpu_count()."""
    env = os.environ.get("LIBDEFLATE_RSX_THREADS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return os.cpu_count() or 1


def _get_pool() -> ThreadPoolExecutor | None:
    global _pool
    width = pool_width()
    if width <= 1:
        return None
    with _lock:
        if _pool is None or _pool._max_workers != width:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = ThreadPoolExecutor(max_workers=width,
                                       thread_name_prefix=_PREFIX)
        return _pool


def pmap(fn, items) -> list:
    """Ordered map over the pool; serial for a trivial work list, with
    one worker, or when called from a pool worker (no nested waits).
    Exceptions propagate."""
    items = list(items)
    if len(items) <= 1 or threading.current_thread().name.startswith(_PREFIX):
        return [fn(x) for x in items]
    pool = _get_pool()
    if pool is None:
        return [fn(x) for x in items]
    return list(pool.map(fn, items))
