"""Carry parameters from the JAX package's flax modules into the port's
``torch.nn`` modules."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

__all__ = ["from_flax_params"]

_LEAF_NAMES = {"scale": "weight", "embedding": "weight"}
_GRU_GATES = frozenset(("ir", "iz", "in", "hr", "hz", "hn"))
# flax's per-type child prefix -> (the port's ModuleDict, the leaf every
# such child holds, or None for any module)
_TYPED = {"mods_": ("mods", None), "linear_": ("linears", "kernel"),
          "embed_": ("embeds", "embedding")}


def from_flax_params(params: Mapping[str, Any],
                     rename: Optional[Mapping[str, str]] = None,
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax parameter tree to a ``state_dict``.

    ``params`` is the tree ``Module.init`` returns (with or without its
    ``"params"`` collection key). Nested names join with dots; a
    ``Dense.kernel`` of shape (in, out) becomes the ``Linear.weight`` of
    shape (out, in), and a ``LayerNorm.scale`` its ``weight``; every other
    leaf carries over as it is: biases, GraphConv's (in, out) ``weight``,
    GATConv's (1, H, O) ``attn_l``, ``attn_r`` and ``bias``,
    RelGraphConv's ``weight``, ``basis``, ``coeff``, ``loop_weight`` and
    ``h_bias``, whose port modules keep the reference's shapes.

    An ``Embed.embedding`` becomes ``nn.Embedding.weight`` (both (num,
    dim)); a ``GRUCell`` (children ``ir``, ``iz``, ``in``, ``hr``, ``hz``,
    ``hn``) becomes ``torch.nn.GRUCell``'s ``weight_ih``/``weight_hh``
    (the gates stacked r, z, n) and ``bias_ih``/``bias_hh`` (flax has no
    ``hr`` and ``hz`` bias: those parts are 0).

    The per-type children of the reference's ``HeteroGraphConv``,
    ``HeteroLinear`` and ``HeteroEmbedding`` (a subtree whose children are
    all ``mods_<etype>``, all ``Dense`` named ``linear_<ntype>``, or all
    ``Embed`` named ``embed_<ntype>``) land on the port's
    ``mods.<key>``, ``linears.<key>`` and ``embeds.<key>``, ``key`` being
    ``nn.utils_nn.module_key(type)``.

    ``rename`` maps a subtree's flax path (names joined with ``/``) to the
    port module's dotted name where the two trees differ otherwise: flax
    names a ``HeteroGraphConv``'s modules by the name a user gives them in
    the module that builds them (``l0_<etype>``, a child of that module).
    The leaves may be any array numpy reads; they come out as float32.
    Load the result with ``module.load_state_dict``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    rename = dict(rename or {})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree, path, prefix):
        typed = _typed_children(tree)
        for name, value in tree.items():
            if isinstance(value, Mapping):
                sub = path + name
                port = (typed(name) if typed is not None else name)
                port = rename.get(sub, prefix + port)
                if set(value) == _GRU_GATES:
                    out.update(_gru_cell(value, port + "."))
                else:
                    walk(value, sub + "/", port + ".")
                continue
            arr = np.array(value, dtype=np.float32)
            if name == "kernel":
                out[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(arr.T))
            else:
                out[prefix + _LEAF_NAMES.get(name, name)] = (
                    torch.from_numpy(arr))

    walk(params, "", "")
    return out


def _typed_children(tree):
    """For a subtree whose children are all per-type modules of one kind
    (``_TYPED``), the map from a child's flax name to the port's
    ``<dict>.<module_key(type)>``; else None."""
    from .nn.utils_nn import module_key

    if not tree:
        return None
    for flax_prefix, (attr, leaf) in _TYPED.items():
        if all(name.startswith(flax_prefix) and isinstance(v, Mapping)
               and (leaf is None or leaf in v) for name, v in tree.items()):
            n = len(flax_prefix)
            return lambda name: f"{attr}.{module_key(name[n:])}"
    return None


def _gru_cell(tree, prefix):
    """flax ``GRUCell`` parameters as ``torch.nn.GRUCell``'s."""
    def kernel(g):
        return np.array(tree[g]["kernel"], dtype=np.float32).T

    def bias(g):
        if "bias" in tree[g]:
            return np.array(tree[g]["bias"], dtype=np.float32)
        return np.zeros(np.shape(tree[g]["kernel"])[-1], np.float32)

    stack = {"weight_ih": [kernel(g) for g in ("ir", "iz", "in")],
             "weight_hh": [kernel(g) for g in ("hr", "hz", "hn")],
             "bias_ih": [bias(g) for g in ("ir", "iz", "in")],
             "bias_hh": [bias(g) for g in ("hr", "hz", "hn")]}
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(
        np.concatenate(v))) for k, v in stack.items()}
