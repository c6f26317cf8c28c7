"""Ordered message propagation (counterpart of ``dgl_tpu/propagate.py``;
reference ``python/dgl/propagate.py``): ``pull`` or ``send_and_recv``
frontier by frontier along a host-computed traversal, each step a
fixed-shape device pass."""
from __future__ import annotations

import numpy as np

from . import traversal

__all__ = [
    "prop_nodes",
    "prop_edges",
    "prop_nodes_bfs",
    "prop_nodes_topo",
    "prop_edges_dfs",
]


def prop_nodes(graph, nodes_generator, message_func, reduce_func,
               apply_node_func=None, etype=None):
    """``pull`` into each node frontier in turn (reference
    ``propagate.py:13``)."""
    from . import core

    for frontier in nodes_generator:
        core.pull(graph, np.asarray(frontier), message_func, reduce_func,
                  apply_node_func, etype=etype)


def prop_edges(graph, edges_generator, message_func, reduce_func,
               apply_node_func=None, etype=None):
    """``send_and_recv`` along each edge frontier in turn (reference
    ``propagate.py:48``)."""
    from . import core

    for frontier in edges_generator:
        core.send_and_recv(graph, np.asarray(frontier), message_func,
                           reduce_func, apply_node_func, etype=etype)


def prop_nodes_bfs(graph, source, message_func, reduce_func,
                   apply_node_func=None, reverse=False):
    """``prop_nodes`` along the BFS frontiers from ``source``."""
    prop_nodes(graph, traversal.bfs_nodes_generator(graph, source, reverse),
               message_func, reduce_func, apply_node_func)


def prop_nodes_topo(graph, message_func, reduce_func, apply_node_func=None,
                    reverse=False):
    """``prop_nodes`` along the topological frontiers (leaves first on a
    tree whose edges point to the root)."""
    prop_nodes(graph, traversal.topological_nodes_generator(graph, reverse),
               message_func, reduce_func, apply_node_func)


def prop_edges_dfs(graph, source, message_func, reduce_func,
                   apply_node_func=None, reverse=False):
    """``prop_edges`` along the DFS tree edges from ``source``."""
    prop_edges(graph, traversal.dfs_edges_generator(graph, source, reverse),
               message_func, reduce_func, apply_node_func)
