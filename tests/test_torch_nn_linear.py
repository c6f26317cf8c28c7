"""The port's typed linear layers against ``dgl_tpu.nn.linear``:
``TypedLinear`` (with and without the basis, rows sorted by type through
``segment_mm`` and unsorted through ``gather_mm``), ``HeteroLinear``,
``HeteroEmbedding``, ``matmul_maybe_select`` and ``bmm_maybe_select`` (both
routes each); ``HeteroGraphConv`` with edge types that are no legal
``nn.ModuleDict`` keys (``"type"``, ``"a.b"``, ``"to"``); and what
``from_flax_params`` makes of the new parameter trees (``Embed``,
``GRUCell``, the escaped ``mods_``, ``linear_`` and ``embed_`` children).

Forward values and the gradients of ``sum(out * cot)`` for the inputs and
every parameter (the reference's from ``jax.grad``), the parameters
carried over by ``from_flax_params``; inputs made with numpy from a seed.
Tolerance: rtol = 1e-5, atol = 1e-5 * max|ref| (the same f32 operations,
sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import dgl_tpu
from dgl_tpu.nn import HeteroGraphConv as JHeteroGraphConv
from dgl_tpu.nn.conv import GraphConv as JGraphConv
from dgl_tpu.nn.linear import HeteroEmbedding as JHeteroEmbedding
from dgl_tpu.nn.linear import HeteroLinear as JHeteroLinear
from dgl_tpu.nn.linear import TypedLinear as JTypedLinear
from dgl_tpu.nn.linear import bmm_maybe_select as j_bmm
from dgl_tpu.nn.linear import matmul_maybe_select as j_matmul
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import (GraphConv, HeteroEmbedding, HeteroGraphConv,
                              HeteroLinear, TypedLinear, bmm_maybe_select,
                              matmul_maybe_select)
from dgl_tpu_torch.nn.utils_nn import module_key


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _check_grads(jgrads, model, what=""):
    want = dt.from_flax_params(jgrads)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(want) == set(got), (set(want), set(got))
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), f"{what} grad {k}")


# ---------------------------------------------------------------------------
# TypedLinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regularizer", [None, "basis"])
@pytest.mark.parametrize("sort", [False, True])
def test_typed_linear_matches(regularizer, sort):
    n, fin, fout, T = 60, 7, 5, 4
    types = np.random.default_rng(1).integers(0, T, n).astype(np.int32)
    x = _rand((n, fin), 2)
    if sort:
        order = np.argsort(types, kind="stable")
        types, x = types[order], x[order]
    seglen = np.bincount(types, minlength=T).astype(np.int64)
    kw = dict(regularizer=regularizer, num_bases=2 if regularizer else None)
    jm = JTypedLinear(fin, fout, T, **kw)
    tm = TypedLinear(fin, fout, T, device="cpu", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(types))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    cot = _rand((n, fout), 3)
    jargs = dict(sorted_by_type=True, seglen=jnp.asarray(seglen)) if sort \
        else {}
    targs = dict(sorted_by_type=True, seglen=torch.from_numpy(seglen)) \
        if sort else {}

    def loss(p, xx):
        out = jm.apply(p, xx, jnp.asarray(types), **jargs)
        return jnp.sum(out * cot), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(types), **targs)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    _close(xt.grad.numpy(), gx, "dx")
    _check_grads(gp, tm)
    w = tm.get_weight()
    assert tuple(w.shape) == (T, fin, fout)
    with pytest.raises(dt.DGLError, match="regularizer"):
        TypedLinear(3, 3, 2, regularizer="bdd", device="cpu")


# ---------------------------------------------------------------------------
# HeteroLinear, HeteroEmbedding: per-type children under escaped keys
# ---------------------------------------------------------------------------

# types that are no legal ModuleDict keys as they are, and plain ones
TYPES = ("paper", "a.b", "type", "", "to")


@pytest.mark.parametrize("use_bias", [True, False])
def test_hetero_linear_matches(use_bias):
    sizes = {t: 3 + i for i, t in enumerate(TYPES)}
    x = {t: _rand((4 + i, sizes[t]), 10 + i) for i, t in enumerate(TYPES)}
    jm = JHeteroLinear(sizes, 6, use_bias=use_bias)
    tm = HeteroLinear(sizes, 6, use_bias=use_bias, device="cpu")
    params = jm.init(jax.random.PRNGKey(1),
                     {k: jnp.asarray(v) for k, v in x.items()})
    assert {f"linear_{t}" for t in TYPES} == set(params["params"])
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    assert "linears.~a~db.weight" in sd and "linears.~.weight" in sd
    tm.load_state_dict(sd)
    cot = {t: _rand((4 + i, 6), 20 + i) for i, t in enumerate(TYPES)}

    def loss(p, xx):
        out = jm.apply(p, xx)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in x.items()})
    xt = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    out = tm(xt)
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    assert set(out) == set(TYPES)
    for t in TYPES:
        _close(out[t].detach().numpy(), ref[t], f"out {t!r}")
        _close(xt[t].grad.numpy(), gx[t], f"dx {t!r}")
    _check_grads(gp, tm)
    with pytest.raises(dt.DGLError, match="No module"):
        tm({"author": torch.zeros(2, 3)})


def test_hetero_embedding_matches():
    counts = {t: 5 + 2 * i for i, t in enumerate(TYPES)}
    rng = np.random.default_rng(5)
    ids = {t: rng.integers(0, n, 9).astype(np.int32)
           for t, n in counts.items()}
    jm = JHeteroEmbedding(counts, 4)
    tm = HeteroEmbedding(counts, 4, generator=torch.Generator().manual_seed(
        0), device="cpu")
    params = jm.init(jax.random.PRNGKey(2),
                     {k: jnp.asarray(v) for k, v in ids.items()})
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    assert "embeds.~type.weight" in sd
    for t in TYPES:  # Embed's (num, dim) table is nn.Embedding.weight's
        assert tuple(sd[f"embeds.{module_key(t)}.weight"].shape) == (
            counts[t], 4)
    tm.load_state_dict(sd)
    cot = {t: _rand((9, 4), 30 + i) for i, t in enumerate(TYPES)}

    def loss(p):
        out = jm.apply(p, {k: jnp.asarray(v) for k, v in ids.items()})
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, ref), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = tm({k: torch.from_numpy(v) for k, v in ids.items()})
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    for t in TYPES:
        _close(out[t].detach().numpy(), ref[t], f"out {t!r}")
    _check_grads(gp, tm)


def test_hetero_init_distributions():
    """The port draws as flax does: ``Embed`` normal with std
    1/sqrt(dim), ``HeteroLinear`` Xavier-uniform within its bound."""
    gen = torch.Generator().manual_seed(3)
    emb = HeteroEmbedding({"a": 20000}, 64, generator=gen, device="cpu")
    std = emb.embeds["a"].weight.std().item()
    assert abs(std - 64 ** -0.5) < 0.01 * 64 ** -0.5
    lin = HeteroLinear({"a": 300}, 100, generator=gen, device="cpu")
    w = lin.linears["a"].weight
    bound = (6.0 / 400) ** 0.5
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.99 * (
        bound)
    assert not lin.linears["a"].bias.any()


# ---------------------------------------------------------------------------
# matmul_maybe_select, bmm_maybe_select
# ---------------------------------------------------------------------------


def test_matmul_maybe_select():
    B = _rand((6, 4), 40)
    ids = np.array([0, 5, 2, 2, 1], np.int64)
    _close(matmul_maybe_select(torch.from_numpy(ids),
                               torch.from_numpy(B)).numpy(),
           j_matmul(jnp.asarray(ids), jnp.asarray(B)), "select")
    A = _rand((5, 6), 41)
    _close(matmul_maybe_select(torch.from_numpy(A),
                               torch.from_numpy(B)).numpy(),
           j_matmul(jnp.asarray(A), jnp.asarray(B)), "matmul")


def test_bmm_maybe_select():
    B = _rand((3, 6, 4), 42)
    index = np.array([0, 2, 1, 2, 2, 0, 1], np.int64)
    ids = np.array([5, 0, 3, 3, 1, 2, 4], np.int64)
    _close(bmm_maybe_select(torch.from_numpy(ids), torch.from_numpy(B),
                            torch.from_numpy(index)).numpy(),
           j_bmm(jnp.asarray(ids), jnp.asarray(B), jnp.asarray(index)),
           "select")
    A = _rand((7, 6), 43)
    cot = _rand((7, 4), 44)
    ref, vjp = jax.vjp(lambda a, b: j_bmm(a, b, jnp.asarray(index)),
                       jnp.asarray(A), jnp.asarray(B))
    ga, gb = vjp(jnp.asarray(cot))
    At = torch.from_numpy(A).requires_grad_()
    Bt = torch.from_numpy(B).requires_grad_()
    out = bmm_maybe_select(At, Bt, torch.from_numpy(index))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "bmm")
    _close(At.grad.numpy(), ga, "dA")
    _close(Bt.grad.numpy(), gb, "dB")


# ---------------------------------------------------------------------------
# HeteroGraphConv with edge types that are no legal ModuleDict keys
# ---------------------------------------------------------------------------


def test_module_key_is_injective_and_legal():
    names = ["a", "a.b", "", "type", "to", "train", "forward", "keys", "~",
             "~a", "a~db", "~a~db", "x.y.z", "mods"]
    keys = [module_key(n) for n in names]
    assert len(set(keys)) == len(names)
    assert module_key("cites") == "cites" and module_key("a.b") == "~a~db"
    torch.nn.ModuleDict({k: torch.nn.Identity() for k in keys})


def test_hetero_graph_conv_escaped_etypes():
    """Edge types ``"type"``, ``"a.b"`` and ``"to"``: the reference names
    the modules ``mods_<etype>``; the port keys them by ``module_key`` and
    ``from_flax_params`` maps one onto the other. Output and every
    parameter's gradient."""
    rng = np.random.default_rng(7)
    nodes = {"u": 30, "v": 25}
    data = {("u", "type", "v"): (rng.integers(0, 30, 90),
                                 rng.integers(0, 25, 90)),
            ("v", "a.b", "u"): (rng.integers(0, 25, 70),
                                rng.integers(0, 30, 70)),
            ("u", "to", "u"): (rng.integers(0, 30, 80),
                               rng.integers(0, 30, 80))}
    jg = dgl_tpu.heterograph(data, nodes)
    tg = dt.heterograph(data, nodes, device="cpu")
    etypes = ("type", "a.b", "to")
    jm = JHeteroGraphConv({et: JGraphConv(5, 3, allow_zero_in_degree=True)
                           for et in etypes}, aggregate="sum")
    tm = HeteroGraphConv({et: GraphConv(5, 3, allow_zero_in_degree=True,
                                        device="cpu") for et in etypes},
                         aggregate="sum")
    x = {"u": _rand((30, 5), 8), "v": _rand((25, 5), 9)}
    params = jm.init(jax.random.PRNGKey(4), jg,
                     {k: jnp.asarray(v) for k, v in x.items()})
    assert set(params["params"]) == {f"mods_{et}" for et in etypes}
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict()) == {
        f"mods.{k}.{p}" for k in ("~type", "~a~db", "~to")
        for p in ("weight", "bias")}
    tm.load_state_dict(sd)
    assert tm.module("a.b") is tm.mods["~a~db"]
    cot = {"u": _rand((30, 3), 10), "v": _rand((25, 3), 11)}

    def loss(p, xx):
        out = jm.apply(p, jg, xx)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in x.items()})
    xt = {k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
    out = tm(tg, xt)
    sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot).backward()
    assert set(out) == set(ref) == {"u", "v"}
    for k in ref:
        _close(out[k].detach().numpy(), ref[k], k)
        _close(xt[k].grad.numpy(), gx[k], f"d{k}")
    _check_grads(gp, tm)


# ---------------------------------------------------------------------------
# from_flax_params: GRUCell, Embed, the typed children
# ---------------------------------------------------------------------------


def test_from_flax_params_gru_cell():
    """flax's ``GRUCell(carry=h, inputs=a)`` (biases on ir, iz, in and hn
    only) equals ``torch.nn.GRUCell(a, h)`` with its gates stacked r, z, n
    and ``bias_hh``'s r and z parts 0."""
    h, a = _rand((6, 5), 50), _rand((6, 4), 51)

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, h, a):
            return fnn.GRUCell(5, name="gru")(h, a)[0]

    params = J().init(jax.random.PRNGKey(5), jnp.asarray(h), jnp.asarray(a))
    # give hn a non-zero bias so its place is checked
    params = jax.tree_util.tree_map(lambda v: v, params)
    params["params"]["gru"]["hn"]["bias"] = jnp.asarray(_rand((5,), 52))
    params["params"]["gru"]["ir"]["bias"] = jnp.asarray(_rand((5,), 53))
    ref = J().apply(params, jnp.asarray(h), jnp.asarray(a))
    sd = dt.from_flax_params(params)
    assert set(sd) == {"gru.weight_ih", "gru.weight_hh", "gru.bias_ih",
                       "gru.bias_hh"}
    assert not sd["gru.bias_hh"][:10].any()
    m = torch.nn.Module()
    m.gru = torch.nn.GRUCell(4, 5)
    m.load_state_dict(sd)
    out = m.gru(torch.from_numpy(a), torch.from_numpy(h))
    _close(out.detach().numpy(), ref, "gru")


def test_from_flax_params_typed_children():
    """Subtrees of per-type children land on the port's dicts, escaped;
    any other subtree keeps its names, and ``rename`` still wins."""
    k = np.ones((2, 3), np.float32)
    tree = {"params": {
        "lin": {"linear_a.b": {"kernel": k, "bias": np.zeros(3)},
                "linear_x": {"kernel": k}},
        "emb": {"embed_": {"embedding": k}},
        "conv": {"mods_to": {"weight": k}, "mods_c": {"weight": k}},
        "mixed": {"linear_q": {"weight": k}, "skip": np.ones(2)},
        "user": {"l0_to": {"weight": k}}}}
    sd = dt.from_flax_params(tree, rename={"user/l0_to": "user.mods.~to"})
    assert set(sd) == {
        "lin.linears.~a~db.weight", "lin.linears.~a~db.bias",
        "lin.linears.x.weight", "emb.embeds.~.weight",
        "conv.mods.~to.weight", "conv.mods.c.weight",
        "mixed.linear_q.weight", "mixed.skip", "user.mods.~to.weight"}
    assert tuple(sd["lin.linears.x.weight"].shape) == (3, 2)  # transposed
    assert tuple(sd["emb.embeds.~.weight"].shape) == (2, 3)  # as it is
