"""HeteroGraphConv: one module per relation, results aggregated per
destination type (counterpart of ``dgl_tpu/nn/hetero.py``; reference
``python/dgl/nn/pytorch/hetero.py:12``)."""
from __future__ import annotations

from typing import Dict

from torch import nn

from ..base import DGLError
from ..core import CROSS_REDUCERS as _AGG_FNS
from ..graph import Graph
from .utils_nn import module_key

__all__ = ["HeteroGraphConv"]


class HeteroGraphConv(nn.Module):
    """Apply ``mods[etype]`` on each relation and aggregate per dst type.

    ``mods`` maps an edge type name to a module called as
    ``mod(relation_graph, (src_feat, dst_feat), *args, **kwargs)`` on a
    one-relation block that keeps the relation's SpMM plans. A relation
    whose source type has no input is skipped, and a destination type that
    no relation reaches is absent from the output. ``aggregate`` combines
    a type's results: ``sum``, ``max``, ``min``, ``mean`` or ``stack``
    (along dim 1). The modules live in ``self.mods`` (an
    ``nn.ModuleDict``) under ``module_key(etype)``, so their parameters
    are ``mods.<etype>.*`` for an edge type such as ``"cites"`` and
    ``mods.~a~db.*`` for ``"a.b"``; ``self.mods[etype]`` does not find an
    escaped type's module, ``self.module(etype)`` does.
    """

    def __init__(self, mods: Dict[str, nn.Module], aggregate: str = "sum"):
        super().__init__()
        if aggregate not in _AGG_FNS:
            raise DGLError(f"Unknown aggregate {aggregate!r}")
        self._keys = {et: module_key(et) for et in mods}
        self.mods = nn.ModuleDict({self._keys[et]: m
                                   for et, m in mods.items()})
        self.aggregate = aggregate

    def module(self, etype: str) -> nn.Module:
        """The module of edge type ``etype``."""
        return self.mods[self._keys[etype]]

    def forward(self, graph: Graph, inputs, mod_args=None, mod_kwargs=None):
        mod_args = mod_args or {}
        mod_kwargs = mod_kwargs or {}
        outputs: Dict[str, list] = {}
        for cet in graph.canonical_etypes:
            st, et, dt = cet
            if et not in self._keys or st not in inputs:
                continue
            res = self.module(et)(_relation_view(graph, cet),
                                  (inputs[st], inputs.get(dt)),
                                  *mod_args.get(et, ()),
                                  **mod_kwargs.get(et, {}))
            outputs.setdefault(dt, []).append(res)
        agg = _AGG_FNS[self.aggregate]
        return {dt: agg(vals) for dt, vals in outputs.items()}


def _relation_view(graph: Graph, cet) -> Graph:
    """A one-relation bipartite block of ``cet``, with its plans."""
    st, _, dt = cet
    rel = graph._relations[cet]
    return Graph({cet: rel}, {st: rel.num_src}, {dt: rel.num_dst},
                 is_block=True)
