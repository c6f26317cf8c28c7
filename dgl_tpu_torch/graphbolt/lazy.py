"""LazyFeature markers (counterpart of ``dgl_tpu/graphbolt/lazy.py``;
reference ``python/dgl/frame.py:56`` LazyFeature +
``dgl.set_*_lazy_features``): placeholders recorded on a graph frame so the
dataloader's FeatureFetcher knows which fields to materialize per batch."""
from __future__ import annotations

__all__ = [
    "LazyFeature",
    "set_node_lazy_features",
    "set_edge_lazy_features",
    "set_src_lazy_features",
    "set_dst_lazy_features",
]


class LazyFeature:
    """Marker for a feature to be fetched lazily by the pipeline."""

    __slots__ = ("name", "id_")

    def __init__(self, name=None, id_=None):
        self.name = name
        self.id_ = id_

    def __repr__(self):
        return f"LazyFeature(name={self.name!r})"

    def to(self, device):
        """A marker has no data: moving its graph keeps it as it is."""
        return self


def _set(frame, feats):
    if isinstance(feats, dict):
        for k, v in feats.items():
            frame[k] = v if isinstance(v, LazyFeature) else LazyFeature(v)
    else:
        for k in feats:
            frame[k] = LazyFeature(k)


def set_node_lazy_features(g, feats, ntype=None):
    nt = ntype or (g.ntypes[0] if len(g.ntypes) == 1 else None)
    _set(g._node_frames.setdefault(nt, {}), feats)
    return g


def set_edge_lazy_features(g, feats, etype=None):
    cet = g.to_canonical_etype(etype)
    _set(g._edge_frames.setdefault(cet, {}), feats)
    return g


def set_src_lazy_features(g, feats, ntype=None):
    return set_node_lazy_features(g, feats, ntype)


def set_dst_lazy_features(g, feats, ntype=None):
    nt = ntype or (g.dsttypes[0] if len(g.dsttypes) == 1 else None)
    _set(g._dst_frames.setdefault(nt, {}), feats)
    return g
