"""Graph and tensor files (counterpart of ``dgl_tpu/data/serialize.py``;
reference ``python/dgl/data/graph_serialize.py:83,149``
``save_graphs``/``load_graphs``, ``tensor_serialize.py``).

The format is the JAX package's: one ``.npz`` of flat arrays, keyed by a
JSON description of the graphs stored beside them under ``__meta__``. A
file written by either package loads in the other. Loaded graphs and
tensors lie on ``device`` (default ``"cuda"``); a relation's ids keep the
integer type they were saved with (int32 or int64).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import DGLError
from ..graph import Graph, Relation, _asnumpy

__all__ = ["save_graphs", "load_graphs", "save_info", "load_info"]


def _flatten_graph(g: Graph, gid: int, arrays: Dict[str, np.ndarray]) -> dict:
    meta = {
        "is_block": g.is_block,
        "num_src_nodes": dict(g._num_src_nodes),
        "num_dst_nodes": dict(g._num_dst_nodes),
        "relations": [],
        "node_frames": {},
        "dst_frames": {},
        "edge_frames": {},
    }
    for i, (cet, rel) in enumerate(sorted(g._relations.items())):
        key = f"g{gid}_rel{i}"
        arrays[f"{key}_src"], arrays[f"{key}_dst"] = rel.host_arrays(
            "src", "dst")
        meta["relations"].append({
            "etype": list(cet), "key": key, "num_src": rel.num_src,
            "num_dst": rel.num_dst, "num_edges": rel.num_edges})
    for nt, frame in g._node_frames.items():
        meta["node_frames"][nt] = {}
        for k, v in frame.items():
            akey = f"g{gid}_nf_{nt}_{k}"
            arrays[akey] = _asnumpy(v)
            meta["node_frames"][nt][k] = akey
    if g.is_block:
        for nt, frame in g._dst_frames.items():
            meta["dst_frames"][nt] = {}
            for k, v in frame.items():
                akey = f"g{gid}_df_{nt}_{k}"
                arrays[akey] = _asnumpy(v)
                meta["dst_frames"][nt][k] = akey
    for i, (cet, frame) in enumerate(sorted(g._edge_frames.items())):
        meta["edge_frames"][str(i)] = {"etype": list(cet), "fields": {}}
        for k, v in frame.items():
            akey = f"g{gid}_ef{i}_{k}"
            arrays[akey] = _asnumpy(v)
            meta["edge_frames"][str(i)]["fields"][k] = akey
    return meta


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _unflatten_graph(meta: dict, arrays, device) -> Graph:
    rels = {}
    for r in meta["relations"]:
        src = arrays[r["key"] + "_src"]
        idtype = torch.int64 if src.dtype == np.int64 else torch.int32
        rels[tuple(r["etype"])] = Relation.from_coo(
            src, arrays[r["key"] + "_dst"], r["num_src"], r["num_dst"],
            idtype=idtype, num_edges=r["num_edges"], device=device)
    g = Graph(rels,
              {k: int(v) for k, v in meta["num_src_nodes"].items()},
              {k: int(v) for k, v in meta["num_dst_nodes"].items()},
              is_block=meta["is_block"])
    for nt, fields in meta["node_frames"].items():
        g._node_frames[nt] = {k: _tensor(arrays[ak], device)
                              for k, ak in fields.items()}
    for nt, fields in meta.get("dst_frames", {}).items():
        g._dst_frames[nt] = {k: _tensor(arrays[ak], device)
                             for k, ak in fields.items()}
    for ef in meta["edge_frames"].values():
        g._edge_frames[tuple(ef["etype"])] = {
            k: _tensor(arrays[ak], device) for k, ak in ef["fields"].items()}
    return g


def _read_meta(z) -> dict:
    return json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8"))


def save_graphs(filename: str, g_list, labels: Optional[Dict] = None):
    """Write graphs and a dict of label arrays to one compressed ``.npz``
    (reference ``graph_serialize.py:83``)."""
    if isinstance(g_list, Graph):
        g_list = [g_list]
    arrays: Dict[str, np.ndarray] = {}
    metas = [_flatten_graph(g, i, arrays) for i, g in enumerate(g_list)]
    for k, v in (labels or {}).items():
        arrays[f"label_{k}"] = _asnumpy(v)
    arrays["__meta__"] = np.frombuffer(json.dumps(
        {"graphs": metas, "labels": list(labels) if labels else []}
    ).encode("utf-8"), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    np.savez_compressed(filename, **arrays)
    # np.savez appends .npz to a name without it
    if not filename.endswith(".npz") and os.path.exists(filename + ".npz"):
        os.replace(filename + ".npz", filename)


def load_graphs(filename: str, idx_list: Optional[List[int]] = None,
                device="cuda"):
    """(reference ``graph_serialize.py:149``). Returns (graphs, labels),
    on ``device``."""
    if not os.path.exists(filename):
        raise DGLError(f"No such file: {filename}")
    with np.load(filename, allow_pickle=False) as z:
        meta = _read_meta(z)
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    metas = meta["graphs"]
    if idx_list is not None:
        metas = [metas[i] for i in idx_list]
    graphs = [_unflatten_graph(m, arrays, device) for m in metas]
    labels = {k: _tensor(arrays[f"label_{k}"], device)
              for k in meta.get("labels", [])}
    return graphs, labels


def save_info(path: str, info: dict):
    """(reference ``data/utils.py`` ``save_info``): JSON, not pickle."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)


def load_info(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class StorageMetaData:
    """What a saved file holds (reference ``graph_serialize.py``
    ``StorageMetaData``): its graph count, each graph's description and
    the label names."""

    def __init__(self, num_graphs: int, metadata: list, labels=None):
        self.num_graphs = num_graphs
        self.metadata = metadata
        self.labels = labels or {}

    def __repr__(self):
        return f"StorageMetaData(num_graphs={self.num_graphs})"


def load_graph_v2(filename: str, idx_list: Optional[List[int]] = None,
                  device="cuda"):
    """(reference ``graph_serialize.py:149``): the ``.npz`` container is
    the only format."""
    return load_graphs(filename, idx_list, device=device)


def load_graph_v1(filename: str, idx_list: Optional[List[int]] = None,
                  device="cuda"):
    """(reference ``graph_serialize.py:83``): there is no older layout;
    reads the current one."""
    return load_graphs(filename, idx_list, device=device)


def load_labels(filename: str, device="cuda") -> Dict:
    """The labels of a saved graph file (reference ``load_labels``)."""
    with np.load(filename, allow_pickle=False) as z:
        return {k: _tensor(z[f"label_{k}"], device)
                for k in _read_meta(z).get("labels", [])}


def load_labels_v2(filename: str, device="cuda") -> Dict:
    return load_labels(filename, device=device)


def load_labels_v1(filename: str, device="cuda") -> Dict:
    return load_labels(filename, device=device)


def load_tensors(filename: str, device="cuda") -> Dict:
    """A dict of named tensors (reference ``tensor_serialize.py``
    ``load_tensors``), on ``device``."""
    with np.load(filename, allow_pickle=False) as z:
        return {k: _tensor(z[k], device) for k in z.files
                if not k.startswith("__")}


def save_tensors(filename: str, tensors: Dict):
    """(reference ``tensor_serialize.py`` ``save_tensors``)."""
    np.savez(filename, **{k: _asnumpy(v) for k, v in tensors.items()})


def storage_metadata(filename: str) -> StorageMetaData:
    """A saved file's description, without building its graphs."""
    with np.load(filename, allow_pickle=False) as z:
        meta = _read_meta(z)
    return StorageMetaData(num_graphs=len(meta["graphs"]),
                           metadata=meta["graphs"],
                           labels={k: None for k in meta.get("labels", [])})


__all__ += [
    "StorageMetaData", "load_graph_v1", "load_graph_v2",
    "load_labels", "load_labels_v1", "load_labels_v2",
    "load_tensors", "save_tensors", "storage_metadata",
]
