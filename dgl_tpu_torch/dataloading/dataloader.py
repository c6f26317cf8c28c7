"""DataLoader: seed batches, a sampler and a prefetch pipeline
(counterpart of ``dgl_tpu/dataloading/dataloader.py``; reference
``python/dgl/dataloading/dataloader.py`` and GraphBolt's
``graphbolt/dataloader.py:108-191``).

A background thread samples ahead of the consumer (``num_prefetch``
batches), or a thread pool samples several batches at once
(``num_workers > 1``; the native picks release the GIL). The batches are
moved to ``device`` by the thread that samples them, with blocking
copies on that device's default stream, which the consumer's kernels use
too: a copy is complete on the host before the batch is queued, and
ordered on the card before any kernel the consumer issues after taking
it. No pinned buffer is reused, so no copy can race one.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..graph import Graph, _asnumpy

__all__ = ["DataLoader", "NodeDataLoader", "EdgeDataLoader"]


def to_device(x, device):
    """``x`` with every graph and tensor on ``device`` (numpy arrays
    become tensors there), through tuples, lists and dicts."""
    if isinstance(x, Graph) or isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    return x


class DataLoader:
    """Iterate the minibatches ``graph_sampler.sample(graph, batch)`` of
    ``indices`` (seed nodes, or seed edges for an edge-prediction
    sampler), ``batch_size`` at a time, shuffled by the numpy generator
    made from ``seed``. ``use_prefetch_thread`` samples in a background
    thread ``num_prefetch`` batches ahead; ``num_workers > 1`` samples in a
    thread pool (the batches then come in order, but a sampler's own
    generator is drawn from in the order the threads reach it). Every
    batch is moved to ``device`` (default ``"cuda"``). ``ddp_rank`` /
    ``ddp_world_size`` keep a contiguous shard of the indices."""

    def __init__(self, graph, indices, graph_sampler, *,
                 batch_size: int = 1024, shuffle: bool = False,
                 drop_last: bool = False, seed: Optional[int] = None,
                 num_prefetch: int = 2, num_workers: int = 1,
                 use_prefetch_thread: bool = True, device="cuda",
                 ddp_rank: int = 0, ddp_world_size: int = 1):
        self.graph = graph
        self.indices = _asnumpy(indices)
        self.sampler = graph_sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.num_prefetch = num_prefetch
        self.num_workers = num_workers
        self.use_prefetch_thread = use_prefetch_thread
        self._rng = np.random.default_rng(seed)
        if ddp_world_size > 1:
            shard = self.indices.shape[0] // ddp_world_size
            lo = ddp_rank * shard
            self.indices = self.indices[lo:lo + shard]

    def _batches(self):
        idx = self.indices
        if self.shuffle:
            idx = idx[self._rng.permutation(idx.shape[0])]
        for lo in range(0, idx.shape[0], self.batch_size):
            batch = idx[lo:lo + self.batch_size]
            if self.drop_last and batch.shape[0] < self.batch_size:
                return
            yield batch

    def _produce(self, batch):
        return to_device(self.sampler.sample(self.graph, batch), self.device)

    def __iter__(self):
        if not self.use_prefetch_thread:
            for batch in self._batches():
                yield self._produce(batch)
            return
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = []
                for batch in self._batches():
                    futures.append(pool.submit(self._produce, batch))
                    if len(futures) >= self.num_workers + self.num_prefetch:
                        yield futures.pop(0).result()
                for f in futures:
                    yield f.result()
            return
        yield from self._prefetched()

    def _prefetched(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        end, stop, err = object(), threading.Event(), []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches():
                    if stop.is_set() or not put(self._produce(batch)):
                        return
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            # a consumer that stops early releases the worker and the
            # batches it holds
            stop.set()
            t.join()
        if err:
            raise err[0]

    def __len__(self):
        n = self.indices.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


NodeDataLoader = DataLoader
EdgeDataLoader = DataLoader
