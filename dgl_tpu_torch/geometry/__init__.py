"""Geometry utilities (counterpart of ``dgl_tpu/geometry/``; reference
``python/dgl/geometry/``)."""
from .edge_coarsening import neighbor_matching
from .fps import farthest_point_sampler

__all__ = ["farthest_point_sampler", "neighbor_matching"]
