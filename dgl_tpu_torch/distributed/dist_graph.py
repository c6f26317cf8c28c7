"""DistGraph facade and worker split helpers (counterpart of
``dgl_tpu/distributed/dist_graph.py``; reference
``python/dgl/distributed/dist_graph.py:488,1558,1606``).

There are no graph servers: each worker holds its partition
(``load_partition``) and the partition book; cross-part feature movement
happens in collectives (``dist_spmm``, ``hetero_shard``). ``DistGraph``
bundles the local partition with the book so DistDGL-style scripts port
with few edits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import DGLError
from ..graph import _asnumpy

__all__ = [
    "DistGraph",
    "sample_neighbors",
    "node_split",
    "edge_split",
    "exit_client",
]


class DistGraph:
    """(reference ``dist_graph.py:488``). Built from a partition directory
    written by ``partition_graph`` and this worker's rank; the partition
    goes to ``device``."""

    def __init__(self, graph_name_or_path, part_id: int = None,
                 part_config: str = None, device="cuda"):
        from .partition import load_partition

        path = part_config or graph_name_or_path
        if part_id is None:
            from .dist_context import get_rank

            part_id = get_rank()
        self._part_id = part_id
        self.local_partition, self._book = load_partition(path, part_id,
                                                          device=device)

    # -- queries (reference dist_graph.py:700-900) --------------------------

    def get_partition_book(self):
        return self._book

    @property
    def rank(self):
        return self._part_id

    def num_nodes(self, ntype=None):
        return int(self._book.num_nodes())

    def num_edges(self, etype=None):
        return int(np.sum(self._book.meta.get(
            "num_edges", self.local_partition.num_edges())))

    @property
    def ndata(self):
        nt = self.local_partition.ntypes[0]
        return self.local_partition._node_frames.setdefault(nt, {})

    @property
    def edata(self):
        cet = self.local_partition.canonical_etypes[0]
        return self.local_partition._edge_frames.setdefault(cet, {})

    def local_var(self):
        return self.local_partition.local_var()

    # -- owner-local sampling (reference ``graph_services.py:1037``) --------

    def _global_to_local(self):
        if getattr(self, "_g2l", None) is None:
            new_ids = _asnumpy(self.local_partition.ndata["_new_id"])
            g2l = np.full(int(self._book.num_nodes()), -1, np.int64)
            g2l[new_ids] = np.arange(new_ids.shape[0])
            self._g2l = g2l
        return self._g2l

    def sample_neighbors(self, nodes, fanout, edge_dir="in", prob=None,
                         replace=False, seed=None):
        """Sample in-neighbours of OWNED seeds from the local partition
        (reference ``graph_services.py:1037``: every in-edge of an owned
        node is stored with its partition). ``nodes`` are GLOBAL
        (partition-book) ids; the result is an edge subgraph over the
        global id space with GLOBAL edge ids in ``edata[EID]``. Seeds
        owned by another partition raise."""
        if edge_dir != "in":
            raise DGLError("DistGraph.sample_neighbors samples in-edges "
                           "(dst-owner partition placement)")
        from .. import convert
        from ..base import EID
        from ..sampling import sample_neighbors as local_sample

        nodes = np.atleast_1d(np.asarray(_asnumpy(nodes), np.int64))
        lo = int(self._book._ranges[self._part_id])
        hi = int(self._book._ranges[self._part_id + 1])
        if nodes.size and not ((nodes >= lo) & (nodes < hi)).all():
            raise DGLError(
                f"seeds outside this rank's owned range [{lo},{hi}); use "
                "DistNeighborSampler for cross-partition minibatches")
        part = self.local_partition
        local = self._global_to_local()[nodes]
        frontier = local_sample(part, local, fanout, prob=prob,
                                replace=replace, copy_ndata=False,
                                copy_edata=True, seed=seed)
        u_l, v_l = (_asnumpy(a) for a in frontier.edges())
        new_ids = _asnumpy(part.ndata["_new_id"])
        out = convert.graph((new_ids[u_l], new_ids[v_l]),
                            num_nodes=int(self._book.num_nodes()),
                            device=part.device)
        eid = frontier._edge_frames.get(frontier.canonical_etypes[0],
                                        {}).get(EID)
        if eid is not None:
            # the frontier's ids index the LOCAL partition; its stored
            # parent ids make them GLOBAL
            parent = part._edge_frames.get(part.canonical_etypes[0],
                                           {}).get(EID)
            eid = _asnumpy(eid)
            if parent is not None:
                eid = _asnumpy(parent)[eid]
            out.edata[EID] = torch.from_numpy(
                np.ascontiguousarray(eid)).to(part.device)
        return out


def sample_neighbors(g, nodes, fanout, edge_dir="in", prob=None,
                     replace=False, seed=None):
    """Reference-name entry point (``dgl.distributed.sample_neighbors``):
    owner-local sampling on a :class:`DistGraph`; other graphs go to
    :func:`dgl_tpu_torch.sampling.sample_neighbors`."""
    if isinstance(g, DistGraph):
        return g.sample_neighbors(nodes, fanout, edge_dir=edge_dir,
                                  prob=prob, replace=replace, seed=seed)
    from ..sampling import sample_neighbors as local_sample

    return local_sample(g, nodes, fanout, edge_dir=edge_dir, prob=prob,
                        replace=replace, seed=seed)


def _split(ids_or_mask, partition_book, rank, force_even=True):
    arr = np.asarray(_asnumpy(ids_or_mask))
    ids = np.nonzero(arr)[0] if arr.dtype == bool else arr
    k = partition_book.num_partitions
    if rank is None:
        from .dist_context import get_rank

        rank = get_rank()
    if not 0 <= rank < k:
        raise DGLError(f"rank {rank} out of range for {k} partitions")
    # contiguous even split, the remainder to the first ranks (reference
    # ``dist_graph.py:1558`` even_split)
    base, rem = ids.shape[0] // k, ids.shape[0] % k
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return ids[lo:hi]


def node_split(nodes, partition_book=None, ntype="_N", rank=None,
               force_even=True):
    """This worker's share of the given node ids or mask (reference
    ``dist_graph.py:1558``), host int64."""
    return _split(nodes, partition_book, rank, force_even)


def edge_split(edges, partition_book=None, etype="_E", rank=None,
               force_even=True):
    """(reference ``dist_graph.py:1606``)."""
    return _split(edges, partition_book, rank, force_even)


def exit_client():
    """Leave the process group (reference ``dist_context.py``'s RPC client
    teardown)."""
    from .dist_context import exit_client as _exit

    _exit()
