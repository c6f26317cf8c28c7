"""Carry parameters from the JAX package's flax modules into the port's
``torch.nn`` modules."""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Optional

import numpy as np
import torch

__all__ = ["from_flax_params"]


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

    ``rename`` maps a subtree's flax path (names joined with ``/``) to the
    port module's dotted name, where the two trees differ: a
    ``HeteroGraphConv``'s modules are the port's ``mods.<etype>``, while
    flax names them ``mods_<etype>``, or by the name a user gives them in
    the module that builds them (``l0_<etype>``, a child of that module).
    The leaves may be any array numpy reads; they come out as float32.
    Load the result with ``module.load_state_dict``.
    """
    if set(params) == {"params"}:
        params = params["params"]
    rename = dict(rename or {})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree, path, prefix):
        for name, value in tree.items():
            if isinstance(value, Mapping):
                sub = path + name
                walk(value, sub + "/",
                     rename.get(sub, prefix + name) + ".")
                continue
            arr = np.array(value, dtype=np.float32)
            if name == "kernel":
                out[prefix + "weight"] = torch.from_numpy(
                    np.ascontiguousarray(arr.T))
            else:
                out[prefix + ("weight" if name == "scale" else name)] = (
                    torch.from_numpy(arr))

    walk(params, "", "")
    return out
