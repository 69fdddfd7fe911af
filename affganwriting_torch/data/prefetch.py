"""Background-thread batch prefetch.

The port's copy of ``affganwriting_tpu/data/prefetch.py``: one thread pulls
the batch iterator ``depth`` items ahead of the train loop, so building the
numpy batches overlaps the device's work; a bounded queue caps host memory
at ``depth + 1`` batches in flight.  The batch work is numpy (and the
native preprocessing), which releases the GIL in its loops, and arrays
cross to the consumer without a copy.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(batches: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Iterate ``batches`` on a background thread, ``depth`` ahead.

    Yields exactly the source items, in order.  An exception of the source
    is raised at the consumer's next pull.  If the consumer stops early
    (break, ``close()``, garbage collection) the producer unblocks and
    exits, and the thread is joined.  ``depth < 1`` iterates in place.
    """
    if depth < 1:
        yield from batches
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for item in batches:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_DONE)
        except BaseException as exc:  # noqa: BLE001 — raised consumer-side
            q.put(_Failure(exc))

    t = threading.Thread(target=producer, name="batch-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
        # drain, so a producer blocked in put sees ``stop`` and exits
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
