"""Distributed graph services (counterpart of
``dgl_tpu/distributed/graph_services.py``; reference
``python/dgl/distributed/graph_services.py``: merge_graphs:692,
find_edges, in_degrees/out_degrees, sample_etype_neighbors) and the
partition -> GraphBolt conversion (reference ``distributed/partition.py:1965``
``dgl_partition_to_graphbolt``).

In the reference these fan RPC requests out to per-partition servers;
here every query runs against the local partition (each process holds its
part), and ``merge_graphs`` combines per-partition results as the
reference's ``_distributed_access:737`` does.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..graph import _asnumpy

__all__ = [
    "merge_graphs",
    "find_edges",
    "in_degrees",
    "out_degrees",
    "sample_etype_neighbors",
    "load_partition_feats",
    "dgl_partition_to_graphbolt",
    "gb_convert_single_dgl_partition",
    "process_partitions",
    "default_push_handler",
    "default_pull_handler",
    "ServerState",
]


class ServerState:
    """Per-server shared state (reference ``dist_graph.py`` /
    ``rpc_server.py`` ServerState): the loaded partition, its book, and
    the KV store of feature data."""

    def __init__(self, kv_store=None, graph=None, total_num_nodes=0,
                 total_num_edges=0, partition_book=None):
        self.kv_store = kv_store
        self.graph = graph
        self.total_num_nodes = total_num_nodes
        self.total_num_edges = total_num_edges
        self.partition_book = partition_book
        self.roles = {}


def default_push_handler(target, name, id_tensor, data_tensor):
    """In-place row assign (reference ``kvstore.py`` default_push_handler)."""
    target[name][_asnumpy(id_tensor)] = _asnumpy(data_tensor)


def default_pull_handler(target, name, id_tensor):
    """Row gather (reference ``kvstore.py`` default_pull_handler)."""
    return target[name][_asnumpy(id_tensor)]


def merge_graphs(res_list: List, num_nodes: int, exclude_edges=None,
                 device="cuda"):
    """Combine per-partition sampling results into one edge set over the
    global node space (reference ``graph_services.py:692``), a graph on
    ``device``. Each result needs ``global_src`` / ``global_dst`` and
    optional ``global_eids`` / ``etype_ids`` attributes (or (src, dst[,
    eids]) tuples)."""
    from .. import convert
    from ..base import EID, ETYPE

    def fields(res):
        if isinstance(res, tuple):
            src, dst = res[0], res[1]
            eids = res[2] if len(res) > 2 else None
            et = res[3] if len(res) > 3 else None
            return src, dst, eids, et
        return (
            res.global_src, res.global_dst,
            getattr(res, "global_eids", None),
            getattr(res, "etype_ids", None),
        )

    srcs, dsts, eids, etids = [], [], [], []
    for res in res_list:
        s, d, e, t = fields(res)
        srcs.append(_asnumpy(s))
        dsts.append(_asnumpy(d))
        eids.append(None if e is None else _asnumpy(e))
        etids.append(None if t is None else _asnumpy(t))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int64)
    eid = None if not eids or eids[0] is None else np.concatenate(eids)
    etid = None if not etids or etids[0] is None else np.concatenate(etids)
    if exclude_edges is not None and eid is not None:
        mask = ~np.isin(eid, _asnumpy(exclude_edges))
        src, dst, eid = src[mask], dst[mask], eid[mask]
        if etid is not None:
            etid = etid[mask]
    g = convert.graph((src, dst), num_nodes=int(num_nodes), device=device)
    if eid is not None:
        g.edata[EID] = torch.from_numpy(np.ascontiguousarray(eid)).to(device)
    if etid is not None:
        g.edata[ETYPE] = torch.from_numpy(
            np.ascontiguousarray(etid)).to(device)
    return g


def _local_graph_and_map(dist_g):
    part = dist_g.local_partition
    return part, _asnumpy(part.ndata["_new_id"])


def find_edges(dist_g, eids):
    """Global (src, dst) endpoints of global edge ids (reference
    ``graph_services.py`` find_edges over EdgesRequest). Owner-local: the
    edge ids must live in this rank's partition."""
    part, new_ids = _local_graph_and_map(dist_g)
    from ..base import EID

    local_eids = _asnumpy(part.edata[EID]) if EID in part.edata else None
    eids = np.asarray(_asnumpy(eids))
    src, dst = (_asnumpy(a) for a in part.edges())
    if local_eids is not None:
        # each global id's position among the partition's (a sorted
        # search; the reference builds a dict); a missing id raises
        o = np.argsort(local_eids, kind="stable")
        at = np.searchsorted(local_eids[o], eids)
        if ((at >= o.shape[0]) | (local_eids[o][np.minimum(
                at, max(o.shape[0] - 1, 0))] != eids)).any():
            raise KeyError("find_edges: some edge ids are not in this "
                           "partition")
        pos = o[at]
    else:
        pos = eids
    return new_ids[src[pos]], new_ids[dst[pos]]


def in_degrees(dist_g, nodes):
    """Global in-degrees of OWNED nodes (reference ``graph_services.py``
    in_degrees over InDegreeRequest); exact because in-edges live with
    their dst partition."""
    g2l = dist_g._global_to_local()
    local = g2l[_asnumpy(nodes)]
    if (local < 0).any():
        raise ValueError("in_degrees: some nodes are not in this partition")
    return _asnumpy(dist_g.local_partition.in_degrees())[local]


def out_degrees(dist_g, nodes):
    """Out-degrees counted over the local partition (reference
    ``graph_services.py`` out_degrees; cross-part out-edges are counted by
    the owning dst partition: sum across ranks with a ``psum`` for exact
    global out-degrees)."""
    g2l = dist_g._global_to_local()
    local = g2l[_asnumpy(nodes)]
    if (local < 0).any():
        raise ValueError("out_degrees: some nodes are not in this partition")
    return _asnumpy(dist_g.local_partition.out_degrees())[local]


def sample_etype_neighbors(dist_g, nodes, etype_offset, fanout, **kwargs):
    """Per-etype fanout sampling on the homogenized local partition
    (reference ``graph_services.py`` sample_etype_neighbors); seeds are
    GLOBAL ids owned by this rank."""
    from ..sampling import sample_etype_neighbors as _sample

    g2l = dist_g._global_to_local()
    local = g2l[_asnumpy(nodes)]
    if (local < 0).any():
        raise ValueError("seeds must be owned by this partition")
    sub = _sample(
        dist_g.local_partition, local, etype_offset, fanout, **kwargs
    )
    return sub


def load_partition_feats(part_config: str, part_id: int,
                         load_nodes: bool = True, load_edges: bool = True,
                         device="cuda"):
    """Node/edge feature dicts of one partition (reference
    ``distributed/partition.py:408``), on ``device``."""
    from .partition import load_partition

    part, _ = load_partition(part_config, part_id, device=device)
    node_feats = {}
    edge_feats = {}
    if load_nodes:
        for nt in part.ntypes:
            for k, v in part._node_frames.get(nt, {}).items():
                node_feats[f"{nt}/{k}"] = v
    if load_edges:
        for cet in part.canonical_etypes:
            for k, v in part._edge_frames.get(cet, {}).items():
                edge_feats[f"{cet[1]}/{k}"] = v
    return node_feats, edge_feats


def gb_convert_single_dgl_partition(part_config: str, part_id: int,
                                    store_eids: bool = True,
                                    store_inner_node: bool = False,
                                    store_inner_edge: bool = False):
    """Convert ONE written partition into a FusedCSCSamplingGraph and
    store it alongside (reference ``partition.py`` ``gb_convert_single_
    dgl_partition``); returns the output path."""
    from ..graphbolt import from_dglgraph
    from .partition import load_partition

    part, _ = load_partition(part_config, part_id, device="cpu")
    fused = from_dglgraph(part)
    out_dir = part_config if os.path.isdir(part_config) else \
        os.path.dirname(part_config)
    out = os.path.join(out_dir, f"part{part_id}_fused_csc.npz")
    arrays = {
        "csc_indptr": fused.csc_indptr,
        "indices": fused.indices,
        "edge_ids": fused._eids,
    }
    if store_inner_node and "inner_node" in part.ndata:
        arrays["inner_node"] = _asnumpy(part.ndata["inner_node"])
    np.savez(out, **arrays)
    return out


def process_partitions(part_config: str, num_parts: Optional[int] = None,
                       **kwargs):
    """Convert every partition (reference ``partition.py``
    process_partitions helper of dgl_partition_to_graphbolt).
    ``part_config`` may be the partition directory or its json file."""
    if num_parts is None:
        with open(_find_config(part_config)) as f:
            num_parts = json.load(f)["num_parts"]
    return [
        gb_convert_single_dgl_partition(part_config, p, **kwargs)
        for p in range(num_parts)
    ]


def dgl_partition_to_graphbolt(part_config: str, *, store_eids: bool = True,
                               store_inner_node: bool = False,
                               store_inner_edge: bool = False,
                               graph_formats=None, n_jobs: int = 1):
    """(reference ``distributed/partition.py:1965``). Converts all
    partitions; ``n_jobs`` > 1 uses a thread pool (conversion is
    numpy-bound)."""
    if n_jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        with open(_find_config(part_config)) as f:
            num_parts = json.load(f)["num_parts"]
        with ThreadPoolExecutor(n_jobs) as pool:
            return list(pool.map(
                lambda p: gb_convert_single_dgl_partition(
                    part_config, p, store_eids=store_eids,
                    store_inner_node=store_inner_node,
                    store_inner_edge=store_inner_edge,
                ),
                range(num_parts),
            ))
    return process_partitions(
        part_config, store_eids=store_eids,
        store_inner_node=store_inner_node,
        store_inner_edge=store_inner_edge,
    )


def _find_config(part_config: str) -> str:
    if os.path.isfile(part_config):
        return part_config
    cfgs = [f for f in os.listdir(part_config) if f.endswith(".json")]
    return os.path.join(part_config, cfgs[0])
