"""Abstract graph/subgraph bases (counterpart of
``dgl_tpu/graphbolt/sampling_graph.py``; reference
``python/dgl/graphbolt/sampling_graph.py:11``,
``sampled_subgraph.py:66``)."""
from __future__ import annotations

from typing import Dict, Union

__all__ = ["SamplingGraph", "SampledSubgraph"]


class SamplingGraph:
    """Base of sampling-capable graph containers (reference
    ``sampling_graph.py:11``)."""

    @property
    def num_nodes(self) -> Union[int, Dict[str, int]]:
        raise NotImplementedError

    @property
    def num_edges(self) -> Union[int, Dict[str, int]]:
        raise NotImplementedError


class SampledSubgraph:
    """Base of per-layer sampled subgraphs (reference
    ``sampled_subgraph.py:66``): implementations expose ``sampled_csc``,
    ``original_row_node_ids``, ``original_column_node_ids``,
    ``original_edge_ids``."""

    @property
    def sampled_csc(self):
        raise NotImplementedError
