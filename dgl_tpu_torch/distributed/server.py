"""Server-side pieces of the reference's control plane (counterpart of
``dgl_tpu/distributed/server.py``; reference ``dist_graph.py:488``
DistGraphServer, ``dist_context.py:114`` CustomPool,
``dist_graph.py:347-460`` data views).

Every process is a peer, and the "server" role reduces to publishing the
local partition into POSIX shared memory for co-located workers (the
reference's shared-memory plane) plus a sampler worker pool. Remote
feature traffic rides the mesh's collectives (``dist_spmm``,
``cooperative``, ``pull_rows_in_shard_map``).
"""
from __future__ import annotations

import enum
import os
import threading
import uuid
from collections.abc import MutableMapping
from typing import Optional

import numpy as np

from ..graph import _asnumpy

__all__ = [
    "DistGraphServer",
    "CustomPool",
    "MpCommand",
    "NodeDataView",
    "EdgeDataView",
    "HeteroNodeView",
    "HeteroEdgeView",
    "PlaceHolder",
]


class PlaceHolder:
    """Marker for 'use the initializer' in KV init (reference
    ``kvstore.py`` PlaceHolder sentinel)."""


class MpCommand(enum.Enum):
    """Worker-pool control commands (reference ``dist_context.py``
    MpCommand)."""

    INIT_RPC = 0
    SET_COLLATE_FN = 1
    CALL_BARRIER = 2
    DELETE_COLLATE_FN = 3
    CALL_COLLATE_FN = 4
    CALL_FN_ALL_WORKERS = 5
    FINALIZE_POOL = 6


class DistGraphServer:
    """Load a partition and publish its structure + features for
    co-located workers (reference ``dist_graph.py:488``). The structure is
    published through :func:`graphbolt
    FusedCSCSamplingGraph.copy_to_shared_memory`; features stay in a
    :class:`~dgl_tpu_torch.distributed.kvstore.KVServer`."""

    def __init__(self, server_id: int, ip_config: Optional[str] = None,
                 num_servers: int = 1, num_clients: int = 0,
                 part_config: str = None, graph_name: str = None,
                 disable_shared_mem: bool = False, device="cuda"):
        from .kvstore import KVServer
        from .partition import load_partition

        self.server_id = server_id
        self.part_id = server_id
        self.graph_name = graph_name
        self.local_partition, self.book = load_partition(
            part_config, self.part_id, device=device
        )
        self.kvstore = KVServer(server_id, num_clients)
        nt = self.local_partition.ntypes[0]
        for key, val in self.local_partition._node_frames.get(
            nt, {}
        ).items():
            self.kvstore.init_data(
                f"node~{nt}~{key}", None, data_tensor=_asnumpy(val)
            )
        self._shm_name = None
        if not disable_shared_mem:
            from ..graphbolt import from_dglgraph

            # unique to this server, so two runs never share a segment;
            # peers read it from ``shared_memory_name``
            name = (f"dgl_tpu_{graph_name or 'graph'}_part{self.part_id}"
                    f"_{os.getpid()}_{uuid.uuid4().hex[:8]}")
            self._fused = from_dglgraph(
                self.local_partition).copy_to_shared_memory(name)
            self._shm_name = name

    @property
    def shared_memory_name(self):
        return self._shm_name

    def start(self):
        """The reference blocks in an RPC service loop; peers here attach
        directly, so start is a no-op kept for workflow parity."""

    def shutdown(self):
        if self._shm_name is not None:
            from multiprocessing import shared_memory

            try:
                shm = shared_memory.SharedMemory(self._shm_name)
                shm.close()
                shm.unlink()
            except FileNotFoundError:
                pass
            self._shm_name = None


class CustomPool:
    """Sampler worker pool (reference ``dist_context.py:114``): N workers
    consuming per-dataloader task queues, results merged into one queue.
    Threads instead of spawn-processes — the samplers are numpy/native
    (GIL-releasing), and thread workers share the partition without the
    reference's shared-memory bootstrapping."""

    def __init__(self, num_workers: int, rpc_config=None):
        import queue as _q
        from collections import deque

        self.num_workers = num_workers
        self.result_queue: "_q.Queue" = _q.Queue()
        self.task_queues = [_q.Queue() for _ in range(num_workers)]
        self._collate = {}
        self.current_proc_id = 0
        # per-dataloader submission order + completed-but-not-consumed
        # results: workers finish out of order and several dataloaders can
        # share the pool, so results are keyed by (name, idx) and handed
        # back in each dataloader's submission order
        self._pending = {}           # name -> deque of submitted idx
        self._done = {}              # (name, idx) -> result
        self._deque = deque
        self._threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self, wid: int):
        while True:
            cmd, payload = self.task_queues[wid].get()
            if cmd is MpCommand.FINALIZE_POOL:
                return
            if cmd is MpCommand.SET_COLLATE_FN:
                name, func = payload
                self._collate[name] = func
            elif cmd is MpCommand.DELETE_COLLATE_FN:
                self._collate.pop(payload, None)
            elif cmd is MpCommand.CALL_COLLATE_FN:
                name, idx, items = payload
                try:
                    out = self._collate[name](items)
                except BaseException as e:  # surfaced to the consumer
                    out = e
                self.result_queue.put((name, idx, out))
            elif cmd is MpCommand.CALL_FN_ALL_WORKERS:
                payload()

    def set_collate_fn(self, func, dataloader_name: str):
        for q in self.task_queues:
            q.put((MpCommand.SET_COLLATE_FN, (dataloader_name, func)))

    def submit_task(self, dataloader_name: str, idx, items):
        self._pending.setdefault(dataloader_name, self._deque()).append(idx)
        q = self.task_queues[self.current_proc_id]
        self.current_proc_id = (self.current_proc_id + 1) % self.num_workers
        q.put((MpCommand.CALL_COLLATE_FN, (dataloader_name, idx, items)))

    def get_result(self, dataloader_name: str, timeout: float = 1800):
        """Next result of THIS dataloader in submission order (results of
        other dataloaders / later tasks are buffered, not dropped)."""
        pending = self._pending.get(dataloader_name)
        if not pending:
            raise RuntimeError(
                f"no submitted tasks for dataloader {dataloader_name!r}"
            )
        want = pending[0]
        key = (dataloader_name, want)
        import time as _time

        end = _time.monotonic() + timeout
        while key not in self._done:
            remaining = end - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"get_result({dataloader_name!r}) timed out"
                )
            name, idx, out = self.result_queue.get(timeout=remaining)
            self._done[(name, idx)] = out
        pending.popleft()
        out = self._done.pop(key)
        if isinstance(out, BaseException):
            raise out
        return out

    def delete_collate_fn(self, dataloader_name: str):
        for q in self.task_queues:
            q.put((MpCommand.DELETE_COLLATE_FN, dataloader_name))

    def close(self):
        for q in self.task_queues:
            q.put((MpCommand.FINALIZE_POOL, None))

    def join(self):
        for t in self._threads:
            t.join(timeout=5)


class NodeDataView(MutableMapping):
    """dict-like over a DistGraph's node data (reference
    ``dist_graph.py:375``)."""

    def __init__(self, g, ntype: Optional[str] = None):
        self._g = g
        self._ntype = ntype or g.local_partition.ntypes[0]

    def _frame(self):
        return self._g.local_partition._node_frames.setdefault(
            self._ntype, {}
        )

    def __getitem__(self, key):
        return self._frame()[key]

    def __setitem__(self, key, value):
        self._frame()[key] = value

    def __delitem__(self, key):
        del self._frame()[key]

    def __iter__(self):
        return iter(self._frame())

    def __len__(self):
        return len(self._frame())


class EdgeDataView(NodeDataView):
    """(reference ``dist_graph.py:420``)."""

    def __init__(self, g, etype=None):
        self._g = g
        self._etype = g.local_partition.to_canonical_etype(etype)

    def _frame(self):
        return self._g.local_partition._edge_frames.setdefault(
            self._etype, {}
        )


class HeteroNodeView:
    """``g.nodes[ntype].data`` accessor (reference
    ``dist_graph.py:347``)."""

    def __init__(self, g):
        self._g = g

    def __getitem__(self, ntype):
        class _Typed:
            def __init__(self, g, nt):
                self.data = NodeDataView(g, nt)

        return _Typed(self._g, ntype)


class HeteroEdgeView:
    """``g.edges[etype].data`` accessor (reference
    ``dist_graph.py:360``)."""

    def __init__(self, g):
        self._g = g

    def __getitem__(self, etype):
        class _Typed:
            def __init__(self, g, et):
                self.data = EdgeDataView(g, et)

        return _Typed(self._g, etype)
