"""Witness prefetch: overlap witness fetching with proving.

The port's copy of ``blobstreamx_tpu/parallel/prefetch.py``: a fetcher
decorator whose ``prefetch(...)`` schedules a batch's witness fetch on a
thread pool; the map circuit's hint calls ``get_data_commitment_inputs``,
which collects the future (blocking only if the fetch has not landed) or
fetches synchronously for a batch that was never announced.

Divergence from the reference, whose announced fetches for checkpointed
jobs are never claimed and whose pool is never shut down: ``release()``
cancels and forgets every unclaimed fetch and shuts the pool down, and
``MapReduceProver`` calls it at the end of every prove. The pool is made
again at the next announcement.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple


class PrefetchingFetcher:
    """Wraps an InputDataFetcher; passes every other attribute through.

    Futures are keyed by the exact (start, end, batch_size) triple the map
    circuit's hint computes, so a collected result is the bytes of a
    synchronous fetch."""

    def __init__(self, inner, max_concurrent: int = 8):
        self._inner = inner
        self._max = max_concurrent
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futures: Dict[Tuple[int, int, int], Future] = {}
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def prefetch(self, start: int, end: int, batch_size: int) -> None:
        """Announce a batch; idempotent per key."""
        key = (start, end, batch_size)
        with self._lock:
            if key in self._futures:
                return
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self._max,
                                                thread_name_prefix="witness-prefetch")
            self._futures[key] = self._pool.submit(
                self._inner.get_data_commitment_inputs, start, end, batch_size)

    def get_data_commitment_inputs(self, start: int, end: int, batch_size: int):
        with self._lock:
            fut = self._futures.pop((start, end, batch_size), None)
        if fut is not None:
            return fut.result()
        return self._inner.get_data_commitment_inputs(start, end, batch_size)

    def pending(self) -> int:
        """Announced fetches not yet claimed."""
        with self._lock:
            return len(self._futures)

    def release(self) -> None:
        """Cancel and forget every unclaimed fetch and shut the pool down."""
        with self._lock:
            futures, self._futures = self._futures, {}
            pool, self._pool = self._pool, None
        for fut in futures.values():
            fut.cancel()
        if pool is not None:
            pool.shutdown(wait=True)
