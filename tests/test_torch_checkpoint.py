"""The port's checkpoints (``dgl_tpu_torch/checkpoint.py``) against
``dgl_tpu/checkpoint.py``: the same flat ``.npz`` layout, so a file that
either package writes loads in the other, leaves exact and ``step`` kept.

The leaf order is JAX's: a dict's sorted keys, an ``OrderedDict``'s
insertion order, lists and tuples in order, ``None`` no leaf; the
``__treedef__`` bytes are the string JAX prints for the same structure.
Also a model's ``state_dict()`` with its Adam state round trip (the
restored model's logits exact), a bf16 tensor, the raises (no target, a
wrong leaf count, orbax).
"""
import collections
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu_torch as dt
from dgl_tpu_torch import checkpoint as tck


class Pair(NamedTuple):
    first: object
    second: object


def _arr(rng, *shape, dtype=np.float32):
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-50, 50, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _structures(rng):
    """name -> a nested structure of numpy leaves."""
    return {
        "nested_dict": {"w": _arr(rng, 3, 4), "b": _arr(rng, 4),
                        "sub": {"z": _arr(rng, 2), "a": _arr(rng, 5, 1),
                                "i": _arr(rng, 6, dtype=np.int32)}},
        "lists_tuples_none": {"layers": [_arr(rng, 2, 2), (_arr(rng, 3),
                                                           None)],
                              "opt": (_arr(rng, 1), [_arr(rng, 2, 3)]),
                              "skip": None},
        "ordered": collections.OrderedDict(
            [("z", _arr(rng, 3)), ("a", _arr(rng, 2, 2)),
             ("m", {"y": _arr(rng, 1), "x": _arr(rng, 4)})]),
        "namedtuple": {"state": Pair(_arr(rng, 3), _arr(rng, 2, 2))},
    }


def _map(tree, fn):
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _map(v, fn))
                                       for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _leaves_equal(got, ref):
    a = jax.tree_util.tree_leaves(_map(got, lambda x: np.asarray(
        x.numpy() if isinstance(x, torch.Tensor) else x)))
    b = jax.tree_util.tree_leaves(_map(ref, np.asarray))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, y)


def _structure(name):
    if name == "flax_gcn":
        g = dgl_tpu.add_self_loop(dgl_tpu.rand_graph(12, 40, seed=0))
        m = dgl_tpu.models.GCN(5, 8, 3)
        params = m.init(jax.random.PRNGKey(0), g, jnp.ones((12, 5)))
        return jax.tree_util.tree_map(np.array, dict(params))
    return _structures(np.random.default_rng(7))[name]


NAMES = ["nested_dict", "lists_tuples_none", "ordered", "namedtuple",
         "flax_gcn"]


@pytest.mark.parametrize("name", NAMES)
def test_reference_file_loads_in_the_port(name, tmp_path):
    state = _structure(name)
    path = str(tmp_path / "ref.npz")
    dgl_tpu.save_checkpoint(path, _map(state, jnp.asarray), step=7)
    target = _map(state, lambda x: torch.zeros(x.shape, dtype=torch.from_numpy(
        np.zeros(0, x.dtype)).dtype))
    got, step = dt.load_checkpoint(path, target, return_step=True)
    assert step == 7
    _leaves_equal(got, state)
    assert jax.tree_util.tree_structure(_map(got, lambda x: 0)) == \
        jax.tree_util.tree_structure(_map(state, lambda x: 0))


@pytest.mark.parametrize("name", NAMES)
def test_port_file_loads_in_the_reference(name, tmp_path):
    state = _structure(name)
    path = str(tmp_path / "port")  # ".npz" appended, as the reference does
    assert dt.save_checkpoint(path, _map(state, torch.from_numpy),
                              step=11) == path
    target = _map(state, lambda x: jnp.zeros(x.shape, x.dtype))
    got, step = dgl_tpu.load_checkpoint(path, target, return_step=True)
    assert step == 11
    _leaves_equal(got, state)


@pytest.mark.parametrize("name", NAMES)
def test_treedef_is_the_string_jax_prints(name, tmp_path):
    state = _structure(name)
    dt.save_checkpoint(str(tmp_path / "p.npz"), _map(state, torch.from_numpy))
    dgl_tpu.save_checkpoint(str(tmp_path / "j.npz"), state)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert bytes(p["__treedef__"]) == bytes(j["__treedef__"])
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert np.array_equal(p[k], j[k]), k


def test_state_dict_and_adam_round_trip(tmp_path):
    torch.manual_seed(0)
    g = dt.add_self_loop(dt.rand_graph(30, 120, seed=0, device="cpu"))
    x = torch.randn(30, 6)
    y = torch.randint(0, 3, (30,))

    def make():
        m = dt.models.GCN(6, 8, 3, dropout=0.0, device="cpu")
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)

    def step(m, opt):
        loss = torch.nn.functional.cross_entropy(m(g, x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()

    model, opt = make()
    for _ in range(3):
        step(model, opt)
    path = str(tmp_path / "ck.npz")
    dt.save_checkpoint(path, {"model": model.state_dict(),
                              "opt": opt.state_dict()}, step=3)
    fresh, fresh_opt = make()
    step(fresh, fresh_opt)  # an Adam state of the same structure
    state, n = dt.load_checkpoint(path, {"model": fresh.state_dict(),
                                         "opt": fresh_opt.state_dict()},
                                  return_step=True)
    assert n == 3
    for k, v in opt.state_dict()["state"].items():
        for name, t in v.items():  # Adam's 0-d step stays 0-d
            got = state["opt"]["state"][k][name]
            assert got.shape == t.shape and torch.equal(got, t), (k, name)
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["opt"])
    assert torch.equal(fresh(g, x), model(g, x))
    assert fresh_opt.state_dict()["param_groups"] == \
        opt.state_dict()["param_groups"]
    step(model, opt)
    step(fresh, fresh_opt)
    assert torch.equal(fresh(g, x), model(g, x))


def test_bf16_and_scalar_leaves(tmp_path):
    t = torch.randn(4, 3).bfloat16()
    state = {"t": t, "lr": 0.5, "flag": True, "n": 3, "name": "adam"}
    path = str(tmp_path / "s.npz")
    dt.save_checkpoint(path, state)
    got = dt.load_checkpoint(path, {"t": torch.zeros(4, 3,
                                                     dtype=torch.bfloat16),
                                    "lr": 0.0, "flag": False, "n": 0,
                                    "name": ""})
    assert got["t"].dtype == torch.bfloat16 and torch.equal(got["t"], t)
    assert {k: got[k] for k in ("lr", "flag", "n", "name")} == {
        "lr": 0.5, "flag": True, "n": 3, "name": "adam"}
    assert type(got["n"]) is int and type(got["flag"]) is bool


def test_raises_as_the_reference(tmp_path):
    path = str(tmp_path / "r.npz")
    dt.save_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="target"):
        dt.load_checkpoint(path)
    with pytest.raises(ValueError, match="target"):
        dgl_tpu.load_checkpoint(path)
    with pytest.raises(ValueError, match="leaves"):
        dt.load_checkpoint(path, {"a": torch.ones(2), "b": torch.ones(1)})
    with pytest.raises(NotImplementedError, match="orbax"):
        dt.save_checkpoint(path, {"a": torch.ones(2)}, use_orbax=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        dt.load_checkpoint(path, {"a": torch.ones(2)}, use_orbax=True)
    assert tck.__all__ == ["save_checkpoint", "load_checkpoint"]
