"""Datasets and their files (counterpart of ``dgl_tpu/data/``). Ported so
far: graph and tensor files (``serialize``); the datasets, parsers and
generators are ROADMAP queue A10."""
from .serialize import (StorageMetaData, load_graph_v1, load_graph_v2,
                        load_graphs, load_info, load_labels, load_labels_v1,
                        load_labels_v2, load_tensors, save_graphs, save_info,
                        save_tensors, storage_metadata)

__all__ = [
    "StorageMetaData", "load_graph_v1", "load_graph_v2", "load_graphs",
    "load_info", "load_labels", "load_labels_v1", "load_labels_v2",
    "load_tensors", "save_graphs", "save_info", "save_tensors",
    "storage_metadata",
]
