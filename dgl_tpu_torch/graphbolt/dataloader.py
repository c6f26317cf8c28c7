"""GraphBolt DataLoader (counterpart of ``dgl_tpu/graphbolt/dataloader.py``;
reference ``python/dgl/graphbolt/dataloader.py:78``).

The reference rewrites the datapipe graph before iteration
(``dataloader.py:108-191``): it inserts multiprocessing and a prefetcher
before the trailing ``CopyTo`` and makes the host-to-device copies
non-blocking, so transfer overlaps sampling and compute. Here:

- the whole stage chain, a trailing :class:`CopyTo` included, runs in a
  background prefetch thread, so batch k+1's sampling, feature fetch and
  copy overlap the consumer's compute on batch k; the bounded queue
  (``num_prefetch``) holds finished batches. The thread's copies and
  device gathers go on its current stream, the device's default stream,
  which the consumer's kernels use too, and its copies are blocking: a
  batch is on the card before it is queued, and ordered before any kernel
  the consumer issues after taking it;
- ``overlap_copy=True`` peels the trailing ``CopyTo`` stages off the
  thread and applies them on the consumer's thread (on its current
  stream) with one batch of lookahead.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable

__all__ = ["DataLoader"]


def _split_trailing_copy(pipe):
    """If the chain ends in CopyTo stages, peel them off: returns
    (head, [copy stages outermost-last]). Mirrors the reference's
    datapipe-graph walk that relocates the prefetcher before copy_to."""
    from .neighbor_sampler_gb import CopyTo

    copies = []
    while isinstance(pipe, CopyTo):
        copies.append(pipe)
        pipe = pipe.source
    return pipe, list(reversed(copies))


class DataLoader:
    def __init__(self, datapipe: Iterable, num_prefetch: int = 2,
                 use_prefetch_thread: bool = True, overlap_copy: bool = False):
        self.datapipe = datapipe
        self.num_prefetch = num_prefetch
        self.use_prefetch_thread = use_prefetch_thread
        self.overlap_copy = overlap_copy

    def __iter__(self):
        if not self.use_prefetch_thread:
            yield from self.datapipe
            return
        head, copies = (
            _split_trailing_copy(self.datapipe)
            if self.overlap_copy
            else (self.datapipe, [])
        )

        def apply_copies(mb):
            for c in copies:
                mb = c._apply(mb)
            return mb

        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        _END = object()
        err = []

        def worker():
            try:
                for item in head:
                    q.put(item)
            except BaseException as e:
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        pending = None  # one-batch lookahead: copied, not yet yielded
        while True:
            item = q.get()
            if item is _END:
                break
            item = apply_copies(item)  # the copy, on the consumer's stream
            if pending is not None:
                yield pending
            pending = item
        if pending is not None:
            yield pending
        t.join()
        if err:
            raise err[0]

    def __len__(self):
        return len(self.datapipe)
