"""Graph transforms (counterpart of ``dgl_tpu/transforms/functional.py``).

Ported: the relabelling that the SpMM plans need, ``reorder_graph`` with a
given permutation and ``reorder_for_spmm`` (hub plan, and with
``weighted=True`` the shell plan).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import EID, NID, DGLError
from ..graph import Graph, Relation, with_dense_plans

__all__ = ["reorder_graph", "reorder_for_spmm"]


def reorder_graph(g: Graph, node_permute_algo: str = "rcmk",
                  edge_permute_algo: str = "src", store_ids: bool = True,
                  permute_config=None) -> Graph:
    """Relabel nodes (reference ``functional.py`` ``reorder_graph``).

    ``node_permute_algo='custom'`` takes ``permute_config['nodes_perm']``:
    ``perm[i]`` is the old id of new node ``i``. Edges keep their ids and
    order; node features are carried over permuted. The 'rcmk' and 'metis'
    orders come with the graph utilities (ROADMAP queue A9)."""
    if node_permute_algo != "custom":
        if node_permute_algo in ("rcmk", "metis"):
            raise NotImplementedError(
                f"reorder_graph({node_permute_algo!r}): ROADMAP queue A9")
        raise DGLError(f"Unknown node_permute_algo {node_permute_algo!r}")
    n = g.num_nodes()
    rel = g._relation(None)
    src, dst = rel.host_arrays("src", "dst")
    src, dst = src[: rel.num_edges], dst[: rel.num_edges]
    perm = np.asarray((permute_config or {})["nodes_perm"], np.int64)
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[perm] = np.arange(n)
    cet = g.to_canonical_etype(None)
    new_rel = Relation.from_coo(new_of_old[src], new_of_old[dst], n, n,
                                idtype=g.idtype, device=rel.device)
    out = Graph({cet: new_rel}, dict(g._num_src_nodes))
    for c, f in g._edge_frames.items():
        out._edge_frames[c] = {k: v[: rel.num_edges] for k, v in f.items()}
    for nt, f in g._node_frames.items():
        out._node_frames[nt] = {
            k: v[torch.from_numpy(perm).to(v.device)] for k, v in f.items()}
    if store_ids:
        out._node_frames.setdefault(g.ntypes[0], {})[NID] = (
            torch.from_numpy(perm).to(rel.device))
        out._edge_frames.setdefault(cet, {})[EID] = torch.arange(
            rel.num_edges, device=rel.device)
    return out


def reorder_for_spmm(g: Graph, num_hubs=2048, precision: str = "int8",
                     weighted: bool = False, gather_dtype: str = "bf16"):
    """Relabel nodes into the hub plan's dst-rank order and attach the plan.

    With rank order equal to id order, the shell accumulation's final
    unrank gather is the identity and the plan leaves it out. The hub set
    of the first plan is mapped through the relabel and pinned: a freshly
    chosen hub set can differ on degree ties, which would perturb the cold
    degrees and break the identity ranking.

    With ``weighted=True`` the relabelled graph also carries the weighted
    shell plan (``gather_dtype``), as ``with_spmm_plans(weighted=True)``
    attaches it.

    Returns ``(g2, perm)``: ``perm[i]`` is the original id of new node
    ``i``; node features are carried over permuted. Homogeneous graphs
    only.
    """
    from ..ops.hub_spmm import build_hub_plan
    from ..ops.shell_spmm import build_shell_plan

    rel = g._relation(None)
    h = g._auto_num_hubs(rel) if num_hubs == "auto" else int(num_hubs)
    plan = build_hub_plan(rel, h, precision)
    if plan.unrank_dst is None:  # already rank-ordered
        perm = np.arange(g.num_nodes(), dtype=np.int64)
        return g.with_spmm_plans(num_hubs=h, precision=precision,
                                 weighted=weighted,
                                 gather_dtype=gather_dtype), perm
    perm = np.argsort(plan.unrank_dst.cpu().numpy(),
                      kind="stable").astype(np.int64)
    g2 = reorder_graph(g, "custom", store_ids=False,
                       permute_config={"nodes_perm": perm})
    new_of_old = np.empty(perm.shape[0], np.int64)
    new_of_old[perm] = np.arange(perm.shape[0])
    hubs_new = new_of_old[plan.hub_ids.cpu().numpy()[: plan.num_hubs]]
    # the reference attaches with_spmm_plans' plans and then replaces the
    # hub plan with this pinned one; the pinned plan is built directly and
    # the other plans attached as with_spmm_plans would
    rel2 = g2._relation(None)
    key = g2.to_canonical_etype(None)
    rel2 = rel2.with_hub_plan(
        build_hub_plan(rel2, h, precision, hub_ids_override=hubs_new))
    if weighted:
        rel2 = rel2.with_shell_plan(build_shell_plan(rel2, gather_dtype))
    g2._relations = {key: with_dense_plans(rel2)}
    return g2, perm
