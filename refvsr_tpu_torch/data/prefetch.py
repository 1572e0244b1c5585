"""Background-thread prefetching around any batch iterable; counterpart of
``refvsr_tpu/data/prefetch.py``. A daemon thread keeps a bounded queue of
ready host batches, so reading the next batch overlaps the card's work on
this one. An error in the thread is raised on the consumer's side."""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        self._iterable = iterable
        self._depth = depth

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err = []

        def worker():
            try:
                for item in self._iterable:
                    q.put(item)
            except BaseException as e:  # raised on the consumer's side
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


def prefetch(iterable, depth: int = 2):
    return PrefetchIterator(iterable, depth)
