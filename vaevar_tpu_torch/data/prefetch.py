"""Host-side batch prefetching for training streams.

A copy of vaevar_tpu/data/prefetch.py (pure Python), kept in the port so that
the port runs without the JAX package. The trainers consume synchronous
Python iterators (run_train_forecast.pair_iter); on real archives each
batch costs disk reads of 69-channel frames that otherwise serialize with
the device step
(the reference hides this behind its 60-process loader + torch DataLoader
workers, dataset/dataset.py:155-183). `prefetched` decouples producer and
consumer with one worker thread and a bounded queue — batch k+1..k+depth
load while the device trains on batch k. Order-preserving and exception-
transparent, so wrapping any loader is behavior-neutral."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetched(it: Iterable, depth: int = 2) -> Iterator:
    """Iterate `it` on a worker thread, keeping up to `depth` items ready.

    Exceptions raised by the underlying iterator re-raise at the
    consumer's next() in order. The worker is a daemon thread and also
    shuts down promptly when the consumer abandons the iterator (the
    queue slot is released on GC of the generator via close())."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """Blocking put that still honors abandonment — a plain q.put of
        the sentinel/exception would leak the worker (and its queued
        batches) forever when the consumer walks away with a full queue."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put_or_stop(item):
                    return
            put_or_stop(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 — transparent re-raise
            put_or_stop(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
