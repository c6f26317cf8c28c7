"""MiniBatch (counterpart of ``dgl_tpu/graphbolt/minibatch.py``; reference
``python/dgl/graphbolt/minibatch.py:26``): the unified record flowing
through the pipeline."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["MiniBatch"]


@dataclass
class MiniBatch:
    seeds: Any = None                 # seed node ids (or (src, dst) pairs)
    labels: Any = None
    indexes: Any = None
    input_nodes: Any = None           # ids whose features must be fetched
    blocks: Optional[List] = None     # MFG blocks (outermost first)
    sampled_subgraphs: Optional[List] = None  # SampledSubgraphImpl per layer
    node_features: Dict[str, Any] = field(default_factory=dict)
    edge_features: List[Dict[str, Any]] = field(default_factory=list)
    negative_srcs: Any = None
    negative_dsts: Any = None
    timestamp: Any = None             # per-seed timestamps (temporal sampling)
    device_mfg: Any = None            # on-device DeviceMFG (device backend)

    def num_seeds(self):
        return None if self.seeds is None else len(self.seeds)

    def __repr__(self):
        parts = []
        for k in ("seeds", "labels", "input_nodes"):
            v = getattr(self, k)
            if v is not None:
                parts.append(f"{k}={getattr(v, 'shape', len(v))}")
        if self.blocks:
            parts.append(f"blocks={len(self.blocks)}")
        if self.node_features:
            parts.append(f"node_features={list(self.node_features)}")
        return f"MiniBatch({', '.join(parts)})"


from collections import namedtuple

# PyG-style per-layer tuples (reference ``minibatch.py`` PyGLayerData /
# PyGLayerHeteroData, used by MiniBatch.to_pyg_data): (x, edge_index,
# size) with size = (num_src, num_dst).
PyGLayerData = namedtuple("PyGLayerData", ["x", "edge_index", "size"])
PyGLayerHeteroData = namedtuple(
    "PyGLayerHeteroData", ["x_dict", "edge_index_dict", "size_dict"]
)

__all__ += ["PyGLayerData", "PyGLayerHeteroData"]


def _mb_to_pyg_layers(self):
    """Convert sampled subgraphs to PyG layer tuples (reference
    ``minibatch.py`` to_pyg_data): edge_index rows are (src, dst) in the
    compacted space."""
    import numpy as np

    layers = []
    feat = self.node_features.get("feat")
    for sub in self.sampled_subgraphs or []:
        indptr = np.asarray(sub.sampled_csc.indptr)
        indices = np.asarray(sub.sampled_csc.indices)
        dst = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
        edge_index = np.stack([indices, dst])
        num_dst = indptr.shape[0] - 1
        num_src = (
            len(sub.original_row_node_ids)
            if sub.original_row_node_ids is not None
            else (int(indices.max()) + 1 if indices.size else num_dst)
        )
        layers.append(PyGLayerData(feat, edge_index, (num_src, num_dst)))
    return layers


MiniBatch.to_pyg_layers = _mb_to_pyg_layers


def _mb_to_dgl_blocks(self, device="cuda"):
    """Convert compacted ``sampled_subgraphs`` into MFG blocks on
    ``device`` (reference ``minibatch.py:172-194`` ``MiniBatch.blocks``):
    each layer's CSC (rows compacted against ``original_row_node_ids``)
    becomes a bipartite block whose ``srcdata[NID]``/``dstdata[NID]``
    carry the ORIGINAL graph ids and ``edata[EID]`` the original edge ids
    (int64). Outermost layer first (feed ``model(blocks, x)`` directly)."""
    import numpy as np
    import torch

    from .. import convert
    from ..base import EID, NID

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    blocks = []
    for sub in self.sampled_subgraphs or []:
        indptr = np.asarray(sub.sampled_csc.indptr)
        indices = np.asarray(sub.sampled_csc.indices)
        if sub.original_row_node_ids is None:
            raise ValueError(
                "to_dgl_blocks needs COMPACTED subgraphs; chain a "
                "CompactPerLayer stage after each SamplePerLayer"
            )
        rows = np.asarray(sub.original_row_node_ids)
        num_dst = indptr.shape[0] - 1
        dst = np.repeat(np.arange(num_dst, dtype=np.int64),
                        np.diff(indptr))
        blk = convert.create_block(
            (indices.astype(np.int64), dst),
            num_src_nodes=rows.shape[0],
            num_dst_nodes=num_dst,
            device=device,
        )
        blk.srcdata[NID] = put(rows)
        blk.dstdata[NID] = put(sub.original_column_node_ids)
        if sub.original_edge_ids is not None:
            blk.edata[EID] = put(sub.original_edge_ids)
        blocks.append(blk)
    return blocks


MiniBatch.to_dgl_blocks = _mb_to_dgl_blocks
