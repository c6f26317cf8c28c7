"""CSV dataset (counterpart of ``dgl_tpu/data/csv_dataset.py``; reference
``python/dgl/data/csv_dataset.py``): load graphs from ``nodes.csv`` /
``edges.csv`` (+ optional ``graphs.csv``) described by ``meta.yaml`` —
here a ``meta.json`` with the same schema (yaml needs no extra dependency
this way). Graphs and frames lie on ``device``; integer columns are
int64, float columns float32."""
from __future__ import annotations

import csv
import json
import os
from typing import Dict

import numpy as np

from ..base import DGLError
from .dgl_dataset import DGLDataset
from .utils import to_tensor

__all__ = ["CSVDataset"]


def _parse_value(s: str):
    if "," in s:
        return np.array([float(x) for x in s.split(",")], dtype=np.float32)
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def _read_csv(path: str) -> Dict[str, list]:
    with open(path) as f:
        reader = csv.DictReader(f)
        cols: Dict[str, list] = {k: [] for k in reader.fieldnames}
        for row in reader:
            for k, v in row.items():
                cols[k].append(_parse_value(v))
    return cols


class CSVDataset(DGLDataset):
    """Load one or more graphs from CSV files in ``data_path``.

    ``meta.json`` schema (mirrors the reference meta.yaml):
    ``{"dataset_name": ..., "node_data": [{"file_name": "nodes.csv",
    "ntype": "_N"}], "edge_data": [{"file_name": "edges.csv",
    "etype": ["_N", "_E", "_N"]}]}``
    """

    def __init__(self, data_path: str, force_reload=False, verbose=False,
                 transform=None, device="cuda"):
        self.data_path = data_path
        meta_path = os.path.join(data_path, "meta.json")
        if not os.path.exists(meta_path):
            raise DGLError(f"meta.json not found under {data_path}")
        with open(meta_path) as f:
            self.meta = json.load(f)
        super().__init__(
            name=self.meta.get("dataset_name", "csv_dataset"),
            raw_dir=data_path,
            force_reload=force_reload,
            verbose=verbose,
            transform=transform,
            device=device,
        )

    def process(self):
        from .. import convert

        device = self.device
        node_specs = self.meta.get("node_data", [])
        edge_specs = self.meta.get("edge_data", [])
        node_cols = {}
        num_nodes = {}
        for spec in node_specs:
            nt = spec.get("ntype", "_N")
            cols = _read_csv(os.path.join(self.data_path, spec["file_name"]))
            node_cols[nt] = cols
            num_nodes[nt] = len(cols["node_id"])
        data_dict = {}
        edge_cols = {}
        for spec in edge_specs:
            et = spec.get("etype", ["_N", "_E", "_N"])
            cet = tuple(et)
            cols = _read_csv(os.path.join(self.data_path, spec["file_name"]))
            src = np.array(cols["src_id"], dtype=np.int64)
            dst = np.array(cols["dst_id"], dtype=np.int64)
            data_dict[cet] = (src, dst)
            edge_cols[cet] = cols
        if len(data_dict) == 1 and next(iter(data_dict)) == ("_N", "_E", "_N"):
            (src, dst) = next(iter(data_dict.values()))
            n = num_nodes.get("_N") or int(max(src.max(), dst.max())) + 1
            g = convert.graph((src, dst), num_nodes=n, device=device)
        else:
            g = convert.heterograph(data_dict,
                                    num_nodes_dict=num_nodes or None,
                                    device=device)
        for nt, cols in node_cols.items():
            for k, vals in cols.items():
                if k == "node_id":
                    continue
                arr = np.array(vals)
                if arr.dtype == object:
                    arr = np.stack(vals)
                order = np.argsort(np.array(cols["node_id"], dtype=np.int64))
                g._node_frames.setdefault(nt, {})[k] = to_tensor(arr[order],
                                                                 device)
        for cet, cols in edge_cols.items():
            for k, vals in cols.items():
                if k in ("src_id", "dst_id"):
                    continue
                arr = np.array(vals)
                if arr.dtype == object:
                    arr = np.stack(vals)
                g._edge_frames.setdefault(cet, {})[k] = to_tensor(arr, device)
        self._graphs = [g]

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)


# -- CSV schema + data classes (reference ``data/csv_dataset_base.py``) -------


class MetaNode:
    """Node-file schema entry (reference ``csv_dataset_base.py:15``)."""

    def __init__(self, file_name: str, ntype: str = "_V", **kwargs):
        self.file_name = file_name
        self.ntype = ntype


class MetaEdge:
    """Edge-file schema entry (reference ``csv_dataset_base.py:24``)."""

    def __init__(self, file_name: str, etype=None, **kwargs):
        self.file_name = file_name
        self.etype = tuple(etype) if etype else ("_V", "_E", "_V")


class MetaGraph:
    """Graph-file schema entry (reference ``csv_dataset_base.py:34``)."""

    def __init__(self, file_name: str, **kwargs):
        self.file_name = file_name


class MetaYaml:
    """Top-level schema (reference ``csv_dataset_base.py:41``); parsed
    from ``meta.json``/``meta.yaml`` dicts."""

    def __init__(self, version: str = "1.0.0", dataset_name: str = "csv",
                 node_data=None, edge_data=None, graph_data=None, **kwargs):
        self.version = version
        self.dataset_name = dataset_name
        self.node_data = [
            m if isinstance(m, MetaNode) else MetaNode(**m)
            for m in (node_data or [])
        ]
        self.edge_data = [
            m if isinstance(m, MetaEdge) else MetaEdge(**m)
            for m in (edge_data or [])
        ]
        self.graph_data = (
            graph_data if isinstance(graph_data, (MetaGraph, type(None)))
            else MetaGraph(**graph_data)
        )


class BaseData:
    """Shared csv-column logic (reference ``csv_dataset_base.py:108``)."""

    RESERVED = ("node_id", "src_id", "dst_id", "graph_id", "label",
                "train_mask", "val_mask", "test_mask")

    @staticmethod
    def split_data(cols: Dict[str, list]):
        """Split raw columns into (ids/masks, feature dict)."""
        special = {k: v for k, v in cols.items() if k in BaseData.RESERVED}
        feats = {
            k: v for k, v in cols.items() if k not in BaseData.RESERVED
        }
        return special, feats


class NodeData(BaseData):
    """Parsed nodes.csv (reference ``csv_dataset_base.py:128``)."""

    def __init__(self, node_id, data, ntype: str = "_V",
                 graph_id=None):
        self.id = np.asarray(node_id, dtype=np.int64)
        self.data = data
        self.type = ntype
        self.graph_id = (
            np.asarray(graph_id, dtype=np.int64) if graph_id is not None
            else np.zeros(self.id.shape[0], np.int64)
        )

    @staticmethod
    def load_from_csv(meta: MetaNode, base_dir: str, data_parser=None):
        cols = _read_csv(os.path.join(base_dir, meta.file_name))
        parser = data_parser or DefaultDataParser()
        special, feats = BaseData.split_data(cols)
        return NodeData(
            special["node_id"], parser(feats), ntype=meta.ntype,
            graph_id=special.get("graph_id"),
        )


class EdgeData(BaseData):
    """Parsed edges.csv (reference ``csv_dataset_base.py:194``)."""

    def __init__(self, src_id, dst_id, data, etype=("_V", "_E", "_V"),
                 graph_id=None):
        self.src = np.asarray(src_id, dtype=np.int64)
        self.dst = np.asarray(dst_id, dtype=np.int64)
        self.data = data
        self.type = tuple(etype)
        self.graph_id = (
            np.asarray(graph_id, dtype=np.int64) if graph_id is not None
            else np.zeros(self.src.shape[0], np.int64)
        )

    @staticmethod
    def load_from_csv(meta: MetaEdge, base_dir: str, data_parser=None):
        cols = _read_csv(os.path.join(base_dir, meta.file_name))
        parser = data_parser or DefaultDataParser()
        special, feats = BaseData.split_data(cols)
        return EdgeData(
            special["src_id"], special["dst_id"], parser(feats),
            etype=meta.etype, graph_id=special.get("graph_id"),
        )


class GraphData(BaseData):
    """Parsed graphs.csv (reference ``csv_dataset_base.py:271``)."""

    def __init__(self, graph_id, data):
        self.graph_id = np.asarray(graph_id, dtype=np.int64)
        self.data = data

    @staticmethod
    def load_from_csv(meta: MetaGraph, base_dir: str, data_parser=None):
        cols = _read_csv(os.path.join(base_dir, meta.file_name))
        parser = data_parser or DefaultDataParser()
        special, feats = BaseData.split_data(cols)
        gid = special.get("graph_id", cols.get("graph_id"))
        return GraphData(gid, parser(feats))


# single-graph alias used by the hetero path (reference
# ``csv_dataset_base.py`` HeteroGraphData role)
HeteroGraphData = GraphData


class DefaultDataParser:
    """Column dict -> numpy feature dict (reference
    ``csv_dataset_base.py:367``): numeric columns stack to arrays,
    comma-separated cells become float vectors."""

    def __call__(self, df: Dict[str, list]) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in df.items():
            out[k] = np.asarray(v)
        return out


class DGLGraphConstructor:
    """Assemble Graph objects from Node/Edge/GraphData (reference
    ``csv_dataset_base.py:321``), on ``device``."""

    @staticmethod
    def construct_graphs(node_data, edge_data, graph_data=None,
                         device="cuda"):
        from .. import convert

        if not isinstance(node_data, (list, tuple)):
            node_data = [node_data]
        if not isinstance(edge_data, (list, tuple)):
            edge_data = [edge_data]
        graph_ids = sorted(
            set(np.concatenate([nd.graph_id for nd in node_data]).tolist())
        )
        graphs = []
        for gid in graph_ids:
            data_dict = {}
            num_nodes_dict = {}
            for nd in node_data:
                sel = nd.graph_id == gid
                num_nodes_dict[nd.type] = int(sel.sum())
            for ed in edge_data:
                sel = ed.graph_id == gid
                data_dict[ed.type] = (ed.src[sel], ed.dst[sel])
            g = convert.heterograph(
                data_dict, num_nodes_dict=num_nodes_dict, device=device
            )
            for nd in node_data:
                sel = nd.graph_id == gid
                order = np.argsort(nd.id[sel])
                for k, v in nd.data.items():
                    g._node_frames.setdefault(nd.type, {})[k] = to_tensor(
                        np.asarray(v)[sel][order], device
                    )
            for ed in edge_data:
                sel = ed.graph_id == gid
                for k, v in ed.data.items():
                    g._edge_frames.setdefault(ed.type, {})[k] = to_tensor(
                        np.asarray(v)[sel], device
                    )
            graphs.append(g)
        gdata = {}
        if graph_data is not None:
            gdata = {
                k: to_tensor(np.asarray(v), device)
                for k, v in graph_data.data.items()
            }
        return graphs, gdata


__all__ += [
    "MetaYaml", "MetaNode", "MetaEdge", "MetaGraph",
    "BaseData", "NodeData", "EdgeData", "GraphData", "HeteroGraphData",
    "DefaultDataParser", "DGLGraphConstructor",
]
