"""Training-state checkpoints (counterpart of ``dgl_tpu/checkpoint.py``):
the JAX package's flat ``.npz`` layout, so a file that either package
writes loads in the other.

The file holds ``leaf_<i>`` for the state's leaves in JAX's pytree order,
``__treedef__`` (the structure's description as JAX prints it, as bytes;
no reader uses it) and ``__step__`` when a step is given. The order:

- a ``dict`` by its sorted keys;
- an ``OrderedDict`` (a ``state_dict()``) in insertion order;
- a ``list``, a ``tuple`` and a named tuple in order;
- ``None`` is no leaf;
- anything else is one leaf: a tensor, an array, a Python scalar or
  string.

So a flax parameter tree and its ``from_flax_params`` ``state_dict`` do
not share an order (sorted names against module order); a nested dict of
the same keys does. Orbax, a JAX library, is not available:
``use_orbax=True`` raises.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def _no_orbax():
    raise NotImplementedError(
        "orbax checkpoints are a JAX library's format; the port writes and "
        "reads the flat .npz layout only")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(node):
    """(children, description) of a pytree node, or None for a leaf."""
    if isinstance(node, OrderedDict):
        keys = list(node)
        return ([node[k] for k in keys],
                lambda subs: (f"CustomNode(OrderedDict[{tuple(keys)!r}], "
                              f"[{', '.join(subs)}])"))
    if isinstance(node, dict):
        keys = sorted(node)
        return ([node[k] for k in keys],
                lambda subs: "{" + ", ".join(
                    f"{k!r}: {s}" for k, s in zip(keys, subs)) + "}")
    if _is_namedtuple(node):
        return (list(node),
                lambda subs: (f"CustomNode(namedtuple[{type(node).__name__}]"
                              f", [{', '.join(subs)}])"))
    if isinstance(node, tuple):
        return (list(node),
                lambda subs: ("(" + subs[0] + ",)" if len(subs) == 1
                              else "(" + ", ".join(subs) + ")"))
    if isinstance(node, list):
        return list(node), lambda subs: "[" + ", ".join(subs) + "]"
    return None


def _flatten(node, leaves: List[Any]) -> str:
    if node is None:
        return "None"
    items = _items(node)
    if items is None:
        leaves.append(node)
        return "*"
    children, describe = items
    return describe([_flatten(c, leaves) for c in children])


def _unflatten(node, it):
    """``node``'s structure with its leaves drawn from ``it``."""
    if node is None:
        return None
    if isinstance(node, OrderedDict):
        return OrderedDict((k, _unflatten(v, it)) for k, v in node.items())
    if isinstance(node, dict):
        out = {k: _unflatten(node[k], it) for k in sorted(node)}
        return {k: out[k] for k in node}  # the target's own key order
    if _is_namedtuple(node):
        return type(node)(*(_unflatten(c, it) for c in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_unflatten(c, it) for c in node)
    return _leaf_like(next(it), node)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bfloat16
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _leaf_like(arr: np.ndarray, target):
    """A stored leaf in the target leaf's kind: a tensor on the target's
    device in its dtype, a Python scalar or string of its type, else the
    array."""
    if isinstance(target, torch.Tensor):
        # np.array, not ascontiguousarray: that makes a 0-d array 1-d
        return torch.from_numpy(np.array(arr, order="C")).to(
            device=target.device, dtype=target.dtype)
    if isinstance(target, (bool, int, float, complex, str)):
        return type(target)(arr.item())
    return arr


def save_checkpoint(path: str, state: Any, *, step: Optional[int] = None,
                    force: bool = True, use_orbax: bool = False):
    """Save a pytree of tensors (a ``state_dict()``, an optimiser's, or
    dicts, lists and tuples of them) to ``path`` (``.npz`` appended when
    missing). Returns ``path``."""
    if use_orbax:
        _no_orbax()
    leaves: List[Any] = []
    treedef = f"PyTreeDef({_flatten(state, leaves)})"
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
    if step is not None:
        arrays["__step__"] = np.asarray(int(step))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    return path


def load_checkpoint(path: str, target: Any = None, *, use_orbax: bool = False,
                    return_step: bool = False):
    """Load a checkpoint into the structure of ``target`` (an example
    pytree: the leaves' count and order must match the file's). Tensors
    come out on each target tensor's device, in its dtype. With
    ``return_step=True`` returns ``(state, step)``; ``step`` is None when
    the checkpoint was saved without one."""
    if use_orbax or os.path.isdir(path):
        _no_orbax()
    f = path if path.endswith(".npz") else path + ".npz"
    with np.load(f, allow_pickle=False) as z:
        n_leaves = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n_leaves)]
        step = int(z["__step__"]) if "__step__" in z.files else None
    if target is None:
        raise ValueError("npz checkpoint restore requires a target pytree")
    want: List[Any] = []
    _flatten(target, want)
    if len(want) != n_leaves:
        raise ValueError(f"checkpoint {f} holds {n_leaves} leaves; the "
                         f"target has {len(want)}")
    state = _unflatten(target, iter(leaves))
    return (state, step) if return_step else state
