"""Module transforms (counterpart of ``dgl_tpu/transforms/module.py``;
reference ``python/dgl/transforms/module.py``): callables ``t(g) -> g'``
over the functional transforms, composable with ``Compose``.

Like the reference, the transforms that set features (``GCNNorm``,
``FeatMask``, ``RowFeatNormalizer``, the positional encodings,
``SIGNDiffusion``) write them into the graph they are given and return
it. The random ones draw from ``np.random.default_rng(seed)`` on the host,
the reference's generator, so equal seeds give the reference's masks,
drops, edges and permutations.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..base import DGLError
from ..graph import Graph
from . import functional as F

__all__ = [
    "BaseTransform", "Compose", "AddSelfLoop", "RemoveSelfLoop",
    "AddReverse", "ToSimple", "KHopGraph", "GCNNorm", "FeatMask",
    "RowFeatNormalizer", "DropNode", "DropEdge", "AddEdge", "RandomWalkPE",
    "LapPE", "GDC", "SIGNDiffusion", "LineGraph", "AddMetaPaths", "PPR",
    "HeatKernel", "NodeShuffle", "LaplacianPE", "SVDPE", "ToLevi",
]


class BaseTransform:
    """Transform base (reference ``module.py:49``)."""

    def __call__(self, g: Graph) -> Graph:
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__ + "()"


class Compose(BaseTransform):
    """The transforms applied in sequence (reference ``module.py:64``)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, g):
        for t in self.transforms:
            g = t(g)
        return g


class AddSelfLoop(BaseTransform):
    """A self-loop for every node of each relation within one node type,
    the old ones removed first unless ``allow_duplicate`` (reference
    ``module.py:101``; ``new_etypes`` is accepted and ignored, as
    there)."""

    def __init__(self, allow_duplicate=False, new_etypes=False,
                 edge_feat_names=None, fill_data=1.0):
        self.allow_duplicate = allow_duplicate
        self.edge_feat_names = edge_feat_names
        self.fill_data = fill_data

    def __call__(self, g):
        for cet in g.canonical_etypes:
            if cet[0] != cet[2]:
                continue
            if not self.allow_duplicate:
                g = F.remove_self_loop(g, etype=cet)
            g = F.add_self_loop(g, edge_feat_names=self.edge_feat_names,
                                fill_data=self.fill_data, etype=cet)
        return g


class RemoveSelfLoop(BaseTransform):
    """The self-loops of each relation within one node type removed."""

    def __call__(self, g):
        for cet in g.canonical_etypes:
            if cet[0] == cet[2]:
                g = F.remove_self_loop(g, etype=cet)
        return g


class AddReverse(BaseTransform):
    """``add_reverse_edges`` (reference ``module.py:328``;
    ``sym_new_etype`` accepted and ignored)."""

    def __init__(self, copy_edata=False, sym_new_etype=False):
        self.copy_edata = copy_edata

    def __call__(self, g):
        return F.add_reverse_edges(g, copy_edata=self.copy_edata)


class ToSimple(BaseTransform):
    def __init__(self, return_counts="count"):
        self.return_counts = return_counts

    def __call__(self, g):
        return F.to_simple(g, return_counts=self.return_counts)


class KHopGraph(BaseTransform):
    def __init__(self, k: int):
        self.k = k

    def __call__(self, g):
        return F.khop_graph(g, self.k)


class GCNNorm(BaseTransform):
    """Symmetric GCN weights ``w / sqrt(d_out(u) d_in(v))`` into
    ``edata[eweight_name]`` (reference ``module.py:1119``), the degrees
    weighted by the edges' ``eweight_name`` if the graph has it, 0 where a
    degree is 0. On the device. A padded edge gets the last node's factors
    times its own weight (1 without one), as the reference's clamped
    gathers give it."""

    def __init__(self, eweight_name: str = "w"):
        self.eweight_name = eweight_name

    def __call__(self, g):
        cet = g.to_canonical_etype(None)
        rel = g._relations[cet]
        src, dst = rel.src.long(), rel.dst.long()
        if self.eweight_name in g._edge_frames.get(cet, {}):
            w = g._edge_frames[cet][self.eweight_name]
            # padded edges' sinks num_dst / num_src fall off the end
            rows = tuple(w.shape[1:])
            deg = w.new_zeros((rel.num_dst + 1,) + rows).index_add(
                0, dst, w)[: rel.num_dst]
            out_deg = w.new_zeros((rel.num_src + 1,) + rows).index_add(
                0, src, w)[: rel.num_src]
        else:
            deg = rel.in_degrees().float()
            out_deg = rel.out_degrees().float()
            w = torch.ones(rel.num_edges_padded, device=rel.device)

        def inv_sqrt(d):
            return torch.where(d > 0, torch.rsqrt(torch.clamp(d, min=1e-12)),
                               0.0)

        new_w = (w * inv_sqrt(out_deg)[src.clamp(max=rel.num_src - 1)]
                 * inv_sqrt(deg)[dst.clamp(max=rel.num_dst - 1)])
        g._edge_frames.setdefault(cet, {})[self.eweight_name] = new_w
        return g


class FeatMask(BaseTransform):
    """Zero a random set of feature columns (probability ``p`` each) of
    the named node and edge features, one draw a feature (reference
    ``module.py:1576``)."""

    def __init__(self, p=0.5, node_feat_names=None, edge_feat_names=None,
                 seed=0):
        self.p = p
        self.node_feat_names = node_feat_names or []
        self.edge_feat_names = edge_feat_names or []
        self._rng = np.random.default_rng(seed)

    def _mask(self, frame, names):
        for k in list(frame):
            if k in names:
                v = frame[k]
                mask = self._rng.random(v.shape[-1]) < self.p
                frame[k] = torch.where(torch.from_numpy(mask).to(v.device),
                                       0, v)

    def __call__(self, g):
        for frame in g._node_frames.values():
            self._mask(frame, self.node_feat_names)
        for frame in g._edge_frames.values():
            self._mask(frame, self.edge_feat_names)
        return g


class RowFeatNormalizer(BaseTransform):
    """Rows of the named features scaled to sum 1 (rows summing to 0 left
    as they are), the feature's minimum subtracted first with
    ``subtract_min`` (reference ``module.py:1662``)."""

    def __init__(self, subtract_min=False, node_feat_names=None,
                 edge_feat_names=None):
        self.subtract_min = subtract_min
        self.node_feat_names = node_feat_names or []
        self.edge_feat_names = edge_feat_names or []

    def _norm(self, v):
        if self.subtract_min:
            v = v - v.min()
        s = v.sum(-1, keepdim=True)
        return v / torch.where(s == 0, 1, s)

    def __call__(self, g):
        for frames, names in ((g._node_frames, self.node_feat_names),
                              (g._edge_frames, self.edge_feat_names)):
            for frame in frames.values():
                for k in names:
                    if k in frame:
                        frame[k] = self._norm(frame[k])
        return g


class DropNode(BaseTransform):
    """The subgraph without a random set of nodes (probability ``p`` each;
    reference ``module.py:1474``)."""

    def __init__(self, p=0.5, seed=0):
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, g):
        from ..subgraph import node_subgraph

        keep = {nt: np.nonzero(self._rng.random(g.num_nodes(nt)) >= self.p)[0]
                for nt in g.ntypes}
        return node_subgraph(g, keep)


class DropEdge(BaseTransform):
    """The graph without a random set of edges (probability ``p`` each;
    reference ``module.py:1522``)."""

    def __init__(self, p=0.5, seed=0):
        self.p = p
        self._rng = np.random.default_rng(seed)

    def __call__(self, g):
        for cet in g.canonical_etypes:
            drop = np.nonzero(self._rng.random(g.num_edges(cet)) < self.p)[0]
            if drop.size:
                g = F.remove_edges(g, drop, etype=cet)
        return g


class AddEdge(BaseTransform):
    """``ratio`` times each relation's edge count of uniform random edges
    appended (reference ``module.py:1749``)."""

    def __init__(self, ratio=0.2, seed=0):
        self.ratio = ratio
        self._rng = np.random.default_rng(seed)

    def __call__(self, g):
        for cet in g.canonical_etypes:
            n_add = int(g.num_edges(cet) * self.ratio)
            if n_add == 0:
                continue
            u = self._rng.integers(0, g.num_src_nodes(cet[0]), n_add)
            v = self._rng.integers(0, g.num_dst_nodes(cet[2]), n_add)
            g = F.add_edges(g, u, v, etype=cet)
        return g


class RandomWalkPE(BaseTransform):
    """``random_walk_pe`` into ``ndata[feat_name]`` (reference
    ``module.py:1858``)."""

    def __init__(self, k: int, feat_name: str = "PE", eweight_name=None):
        self.k = k
        self.feat_name = feat_name
        self.eweight_name = eweight_name

    def __call__(self, g):
        g.ndata[self.feat_name] = F.random_walk_pe(g, self.k,
                                                   self.eweight_name)
        return g


class LapPE(BaseTransform):
    """``lap_pe`` into ``ndata[feat_name]``, the eigenvalues broadcast to
    every node into ``ndata[eigval_name]`` (reference ``module.py:1908``)."""

    def __init__(self, k: int, feat_name: str = "PE", eigval_name=None,
                 padding=False):
        self.k = k
        self.feat_name = feat_name
        self.eigval_name = eigval_name
        self.padding = padding

    def __call__(self, g):
        if self.eigval_name:
            pe, ev = F.lap_pe(g, self.k, self.padding, return_eigval=True)
            g.ndata[self.feat_name] = pe
            g.ndata[self.eigval_name] = ev[None, :].expand(g.num_nodes(),
                                                           self.k)
        else:
            g.ndata[self.feat_name] = F.lap_pe(g, self.k, self.padding)
        return g


class GDC(BaseTransform):
    """Graph diffusion convolution's preprocessing (reference
    ``module.py:1411``): ``ppr`` or ``heat_kernel``, the weights in
    ``edata[eweight_name]``."""

    def __init__(self, diffusion: str = "ppr", alpha: float = 0.15,
                 t: float = 5.0, eps=None, avg_degree: int = 5,
                 eweight_name: str = "w"):
        self.diffusion = diffusion
        self.alpha = alpha
        self.t = t
        self.eps = eps
        self.avg_degree = avg_degree
        self.eweight_name = eweight_name

    def __call__(self, g):
        if self.diffusion == "ppr":
            out = F.ppr(g, alpha=self.alpha, eps=self.eps,
                        avg_degree=self.avg_degree)
        elif self.diffusion == "heat":
            out = F.heat_kernel(g, t=self.t, eps=self.eps,
                                avg_degree=self.avg_degree)
        else:
            raise DGLError(f"Unknown diffusion {self.diffusion!r}")
        if self.eweight_name != "w":
            frame = out._edge_frames[out.canonical_etypes[0]]
            frame[self.eweight_name] = frame.pop("w")
        return out


class SIGNDiffusion(BaseTransform):
    """``sign_diffusion`` (reference ``module.py:1692``)."""

    def __init__(self, k: int, in_feat_name="feat", out_feat_name="out_feat",
                 eweight_name=None, diffuse_op="gcn", alpha=0.2):
        self.k = k
        self.in_feat_name = in_feat_name
        self.out_feat_name = out_feat_name
        self.eweight_name = eweight_name
        self.diffuse_op = diffuse_op
        self.alpha = alpha

    def __call__(self, g):
        return F.sign_diffusion(g, self.k, self.in_feat_name,
                                self.out_feat_name, self.eweight_name,
                                self.diffuse_op, self.alpha)


class LineGraph(BaseTransform):
    def __init__(self, backtracking: bool = True):
        self.backtracking = backtracking

    def __call__(self, g):
        return F.line_graph(g, backtracking=self.backtracking)


class AddMetaPaths(BaseTransform):
    """A new edge type ``name`` for each metapath, joining its reachable
    pairs, the old edge types kept with ``keep_orig_edges`` (reference
    ``module.py`` ``AddMetaPaths``); frames are not carried, as there."""

    def __init__(self, metapaths, keep_orig_edges: bool = True):
        self.metapaths = metapaths
        self.keep_orig_edges = keep_orig_edges

    def __call__(self, g):
        from .. import convert

        data_dict = {}
        if self.keep_orig_edges:
            for cet in g.canonical_etypes:
                data_dict[cet] = g._relations[cet].host_edges()
        for name, metapath in self.metapaths.items():
            mg = F.metapath_reachable_graph(g, metapath)
            st = g.to_canonical_etype(metapath[0])[0]
            dt = g.to_canonical_etype(metapath[-1])[2]
            data_dict[(st, name, dt)] = mg._relation(None).host_edges()
        return convert.heterograph(
            data_dict, {nt: g.num_nodes(nt) for nt in g.ntypes},
            idtype=g.idtype, device=g.device)


class PPR(BaseTransform):
    """``ppr`` (reference ``module.py:1411`` neighbourhood)."""

    def __init__(self, alpha: float = 0.15, eweight_name=None, eps=None,
                 avg_degree: int = 5):
        self.kw = dict(alpha=alpha, eweight_name=eweight_name, eps=eps,
                       avg_degree=avg_degree)

    def __call__(self, g):
        return F.ppr(g, **self.kw)


class HeatKernel(BaseTransform):
    """``heat_kernel``."""

    def __init__(self, t: float = 5.0, eweight_name=None, eps=None,
                 avg_degree: int = 5):
        self.kw = dict(t=t, eweight_name=eweight_name, eps=eps,
                       avg_degree=avg_degree)

    def __call__(self, g):
        return F.heat_kernel(g, **self.kw)


class NodeShuffle(BaseTransform):
    """The nodes relabelled by a random permutation
    (``reorder_graph('custom')``, reference ``module.py``
    ``NodeShuffle``)."""

    def __init__(self, seed=None):
        self._rng = np.random.default_rng(seed)

    def __call__(self, g):
        perm = self._rng.permutation(g.num_nodes())
        return F.reorder_graph(g, node_permute_algo="custom",
                               permute_config={"nodes_perm": perm})


class LaplacianPE(BaseTransform):
    """Deprecated reference alias of ``LapPE``, which stores the (k,)
    eigenvalues themselves in ``ndata[eigval_name]``."""

    def __init__(self, k: int, feat_name: str = "PE", padding: bool = False,
                 eigval_name=None):
        self.k = k
        self.feat_name = feat_name
        self.padding = padding
        self.eigval_name = eigval_name

    def __call__(self, g):
        if self.eigval_name:
            pe, ev = F.lap_pe(g, self.k, padding=self.padding,
                              return_eigval=True)
            g.ndata[self.eigval_name] = ev
        else:
            pe = F.lap_pe(g, self.k, padding=self.padding)
        g.ndata[self.feat_name] = pe
        return g


class SVDPE(BaseTransform):
    """``svd_pe`` (seed 0) into ``ndata[feat_name]``."""

    def __init__(self, k: int, feat_name: str = "svd_pe",
                 padding: bool = False, random_flip: bool = True):
        self.k = k
        self.feat_name = feat_name
        self.padding = padding
        self.random_flip = random_flip

    def __call__(self, g):
        g.ndata[self.feat_name] = F.svd_pe(g, self.k, padding=self.padding,
                                           random_flip=self.random_flip)
        return g


class ToLevi(BaseTransform):
    """``to_levi``."""

    def __call__(self, g):
        return F.to_levi(g)
