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
_LSTM_GATES = ("i", "f", "g", "o")  # flax's and torch's order alike
# flax's automatic names of a lone wrapped module, whose subtree the port
# holds in the wrapping module itself: the PNA and DGN towers' convs and
# the masked LSTM step's cell
_WRAPPERS = frozenset(("PNAConv_0", "DGNConv_0", "OptimizedLSTMCell_0"))
# flax's per-type child prefix -> (the port's ModuleDict, the leaf every
# such child holds, or None for any module); ``Dense_<i>`` (an MLP's
# unnamed layers) and ``layers_<i>`` (a tuple field's modules) become the
# port's ``layers.<i>``
_TYPED = {"mods_": ("mods", None), "linear_": ("linears", "kernel"),
          "embed_": ("embeds", "embedding"), "Dense_": ("layers", "kernel"),
          "layers_": ("layers", None)}
# flax's automatic names of a module's children -> the port's names,
# for child sets that name no per-type or per-layer list: GIN's _MLP
_CHILDREN = {frozenset(("Dense_0", "LayerNorm_0", "Dense_1")): {
    "Dense_0": "linear0", "LayerNorm_0": "norm", "Dense_1": "linear1"}}


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
    dim)), so DeepWalk's and MetaPath2Vec's ``node_embed`` and
    ``context_embed`` tables land on theirs; a ``GRUCell`` (children ``ir``, ``iz``, ``in``, ``hr``, ``hz``,
    ``hn``) becomes ``torch.nn.GRUCell``'s ``weight_ih``/``weight_hh``
    (the gates stacked r, z, n) and ``bias_ih``/``bias_hh`` (flax has no
    ``hr`` and ``hz`` bias: those parts are 0). An
    ``OptimizedLSTMCell`` (children ``ii``, ``if``, ``ig``, ``io`` without
    bias, ``hi``, ``hf``, ``hg``, ``ho`` with one) becomes
    ``torch.nn.LSTMCell``'s ``weight_ih``/``weight_hh`` (the gates stacked
    i, f, g, o), ``bias_ih`` 0 and ``bias_hh`` the ``h*`` biases. A
    subtree named ``PNAConv_0``, ``DGNConv_0`` or ``OptimizedLSTMCell_0``
    (a module that another wraps alone) lands on the wrapping module's
    own names; children all named ``Dense_<i>`` or all ``layers_<i>``
    land on ``layers.<i>``; GIN's ``_MLP`` children ``Dense_0``,
    ``LayerNorm_0`` and ``Dense_1`` land on ``linear0``, ``norm`` and
    ``linear1``.

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
                if name in _WRAPPERS:
                    if _is_lstm(value):
                        out.update(_lstm_cell(value, prefix))
                    else:
                        walk(value, sub + "/", prefix)
                    continue
                port = (typed(name) if typed is not None else name)
                port = rename.get(sub, prefix + port)
                if set(value) == _GRU_GATES:
                    out.update(_gru_cell(value, port + "."))
                elif _is_lstm(value):
                    out.update(_lstm_cell(value, port + "."))
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
    ``<dict>.<module_key(type)>``; for one whose child names ``_CHILDREN``
    lists, the map it gives; else None."""
    from .nn.utils_nn import module_key

    if not tree:
        return None
    names = _CHILDREN.get(frozenset(tree))
    if names is not None:
        return names.__getitem__
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


def _is_lstm(tree) -> bool:
    return set(tree) == {k + g for k in "ih" for g in _LSTM_GATES}


def _lstm_cell(tree, prefix):
    """flax ``OptimizedLSTMCell`` parameters as ``torch.nn.LSTMCell``'s:
    the input kernels carry no bias (``bias_ih`` is 0)."""
    def kernel(g):
        return np.array(tree[g]["kernel"], dtype=np.float32).T

    w_ih = np.concatenate([kernel("i" + g) for g in _LSTM_GATES])
    w_hh = np.concatenate([kernel("h" + g) for g in _LSTM_GATES])
    b_hh = np.concatenate([np.array(tree["h" + g]["bias"], dtype=np.float32)
                           for g in _LSTM_GATES])
    arrays = {"weight_ih": w_ih, "weight_hh": w_hh,
              "bias_ih": np.zeros_like(b_hh), "bias_hh": b_hh}
    return {prefix + k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in arrays.items()}
