"""The port's relational layers against ``dgl_tpu``: ``RelGraphConv``
(no regularizer and the basis decomposition, with and without ``norm``,
``self_loop`` and ``layer_norm``, on a graph with padded edges too),
``RGCN`` on ``to_homogeneous`` of the ogbn-mag-shaped graph, and the
``HeteroGraphConv`` R-GCN of ``examples/rgcn_hetero.py`` with and without
hub plans. Forward values, the input's gradient and every parameter's
gradient of ``sum(out * cot)`` (the reference's from ``jax.grad`` under
``jax.jit``), the parameters carried over by ``from_flax_params``.

The graph is the reference's generator at its defaults (2,000 papers,
19,500 edges over 4 relations, numpy seed 0); inputs and cotangents are
made with numpy from a seed.

Tolerances:

- f32 paths: rtol = 1e-5, atol = 1e-5 * max|ref| (the same f32 operations,
  sums in other orders);
- the int8 hub path (hub plans on every relation): the full-model bound of
  ``tests/test_torch_sage.py``: at most 1 element in 1000 outside
  rtol = atol = 1e-4 (scaled by max|ref|), every element within 2**-8 of
  max|ref|. Both sides round the aggregated rows to bf16; where a table is
  computed (a weight applied before the aggregation, any layer after the
  first), the frameworks' f32 matmuls differ in the last bit and an
  element on a bf16 rounding boundary rounds to the neighbouring value.
  The parameter gradients there are held to the second half of that
  bound alone, every element within 2**-8 of max|ref|: the backward
  rounds its cotangents to bf16 too, and one cotangent element that flips
  moves a whole column of a weight's gradient (64 of 1,024 elements), by
  about 2.4e-4 of max|ref| here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import dgl_tpu
from dgl_tpu.data.synthetic import synthetic_hetero_graph
from dgl_tpu.models import RGCN as JRGCN
from dgl_tpu.nn import HeteroGraphConv as JHeteroGraphConv
from dgl_tpu.nn.conv import GraphConv as JGraphConv
from dgl_tpu.nn.conv import RelGraphConv as JRelGraphConv
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import RGCN
from dgl_tpu_torch.nn import GraphConv, HeteroGraphConv, RelGraphConv


@pytest.fixture(scope="module")
def mag():
    jg = synthetic_hetero_graph()
    data = {cet: (np.asarray(jg._relations[cet].src),
                  np.asarray(jg._relations[cet].dst))
            for cet in jg.canonical_etypes}
    tg = dt.heterograph(data, {nt: jg.num_nodes(nt) for nt in jg.ntypes},
                        device="cpu")
    return jg, tg


@pytest.fixture(scope="module")
def homo(mag):
    jg, tg = mag
    jh, th = dgl_tpu.to_homogeneous(jg), dt.to_homogeneous(tg)
    etypes = np.asarray(jh.edata[dgl_tpu.ETYPE]).astype(np.int32)
    np.testing.assert_array_equal(th.edata[dt.ETYPE].numpy(), etypes)
    return jh, th, etypes


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _ref_grads(module, params, args, x, cot):
    """The reference's output and the gradients of ``sum(out * cot)``
    for the parameters and ``x``, under ``jax.jit`` compiled with
    ``xla_allow_excess_precision`` off: XLA's CPU otherwise keeps f32
    where the hub path rounds its operands to bf16 (as
    ``tests/test_torch_shell_spmm.py`` compiles it)."""
    def loss(p, xx):
        out = module.apply(p, *args(xx))
        return sum(jnp.sum(out[k] * cot[k]) for k in cot) if isinstance(
            out, dict) else jnp.sum(out * cot), out

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, out), (gp, gx) = step.lower(params, x).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, x)
    return out, gp, gx


def _port_grads(model, args, x, cot):
    model.zero_grad(set_to_none=True)
    xt = ({k: torch.from_numpy(v).requires_grad_() for k, v in x.items()}
          if isinstance(x, dict) else torch.from_numpy(x).requires_grad_())
    out = model(*args(xt))
    if isinstance(out, dict):
        loss = sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot)
    else:
        loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    # a parameter that reaches no output has no gradient here, zeros in JAX
    grads = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
             else p.grad.numpy() for k, p in model.named_parameters()}
    # an input that reaches no output has no gradient here, zeros in JAX
    gx = ({k: np.zeros_like(x[k]) if v.grad is None else v.grad.numpy()
           for k, v in xt.items()} if isinstance(xt, dict)
          else xt.grad.numpy())
    return out, grads, gx


def _check_grads(jgrads, tgrads, close, rename=None):
    """Every parameter's gradient: the reference's gradient tree mapped to
    the port's names by ``from_flax_params``, as the parameters were."""
    want = dt.from_flax_params(jgrads, rename)
    assert set(want) <= set(tgrads)
    for k, v in want.items():
        close(tgrads[k], v.numpy(), k)
    for k in set(tgrads) - set(want):  # modules flax never built
        assert not tgrads[k].any(), k


# ---------------------------------------------------------------------------
# RelGraphConv and RGCN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regularizer,norm,self_loop,layer_norm", [
    (None, False, True, False),
    ("basis", True, True, True),
    (None, True, False, True),
    ("basis", False, False, False),
])
def test_relgraphconv_matches(homo, regularizer, norm, self_loop,
                              layer_norm):
    jh, th, etypes = homo
    n, E, fin, fout = th.num_nodes(), th.num_edges(), 12, 7
    kw = dict(regularizer=regularizer, num_bases=2 if regularizer else None,
              self_loop=self_loop, layer_norm=layer_norm)
    jconv = JRelGraphConv(fin, fout, 4, **kw)
    tconv = RelGraphConv(fin, fout, 4, device="cpu", **kw)
    x = _rand((n, fin), 1)
    nrm = np.abs(_rand((E, 1), 2)) + 0.1 if norm else None
    params = jconv.init(jax.random.PRNGKey(0), jh, jnp.asarray(x),
                        jnp.asarray(etypes))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tconv.state_dict())
    tconv.load_state_dict(sd)
    cot = _rand((n, fout), 3)
    jn = None if nrm is None else jnp.asarray(nrm)
    tn = None if nrm is None else torch.from_numpy(nrm)
    ref, jgr, jgx = _ref_grads(
        jconv, params, lambda xx: (jh, xx, jnp.asarray(etypes), jn),
        jnp.asarray(x), jnp.asarray(cot))
    out, tgr, tgx = _port_grads(
        tconv, lambda xx: (th, xx, torch.from_numpy(etypes), tn), x, cot)
    _close(out.detach().numpy(), ref, "out")
    _close(tgx, jgx, "dx")
    _check_grads(jgr, tgr, _close)


def test_relgraphconv_padded_edges():
    """Padded edges (source the virtual row ``num_src``) send no message:
    the real edges' result and gradients equal the reference's, whose
    clamped gather reads the last row there."""
    rng = np.random.default_rng(4)
    n, e, pad = 50, 300, 17
    src = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    et = rng.integers(0, 3, e + pad).astype(np.int32)
    jg = dgl_tpu.graph((src, dst), num_nodes=n, num_edges=e)
    tg = dt.graph((src, dst), num_nodes=n, num_edges=e, device="cpu")
    jconv = JRelGraphConv(5, 4, 3, regularizer="basis", num_bases=2)
    tconv = RelGraphConv(5, 4, 3, regularizer="basis", num_bases=2,
                         device="cpu")
    x, cot = _rand((n, 5), 5), _rand((n, 4), 6)
    params = jconv.init(jax.random.PRNGKey(1), jg, jnp.asarray(x),
                        jnp.asarray(et))
    tconv.load_state_dict(dt.from_flax_params(params))
    ref, jgr, jgx = _ref_grads(
        jconv, params, lambda xx: (jg, xx, jnp.asarray(et)), jnp.asarray(x),
        jnp.asarray(cot))
    out, tgr, tgx = _port_grads(
        tconv, lambda xx: (tg, xx, torch.from_numpy(et)), x, cot)
    _close(out.detach().numpy(), ref, "out")
    _close(tgx, jgx, "dx")
    _check_grads(jgr, tgr, _close)


def test_rgcn_matches(homo):
    """``RGCN(F, 16, 8, num_rels=4, num_bases=2)`` on the homogeneous
    encoding, as ``tests/test_hetero_e2e.py`` builds it."""
    jh, th, etypes = homo
    n = th.num_nodes()
    jm = JRGCN(10, 16, 8, num_rels=4, num_bases=2)
    tm = RGCN(10, 16, 8, num_rels=4, num_bases=2, device="cpu").eval()
    x, cot = _rand((n, 10), 7), _rand((n, 8), 8)
    params = jm.init(jax.random.PRNGKey(2), jh, jnp.asarray(x),
                     jnp.asarray(etypes))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    ref, jgr, jgx = _ref_grads(
        jm, params, lambda xx: (jh, xx, jnp.asarray(etypes)), jnp.asarray(x),
        jnp.asarray(cot))
    out, tgr, tgx = _port_grads(
        tm, lambda xx: (th, xx, torch.from_numpy(etypes)), x, cot)
    _close(out.detach().numpy(), ref, "out")
    _close(tgx, jgx, "dx")
    _check_grads(jgr, tgr, _close)
    with pytest.raises(dt.DGLError, match="regularizer"):
        RelGraphConv(3, 3, 2, regularizer="bdd", device="cpu")


# ---------------------------------------------------------------------------
# the HeteroGraphConv R-GCN (examples/rgcn_hetero.py)
# ---------------------------------------------------------------------------


class JHeteroRGCN(fnn.Module):
    in_feats: int
    hidden: int
    classes: int
    etypes: tuple

    @fnn.compact
    def __call__(self, g, inputs):
        h = JHeteroGraphConv(
            {et: JGraphConv(self.in_feats, self.hidden,
                            allow_zero_in_degree=True, name=f"l0_{et}")
             for et in self.etypes}, aggregate="sum", name="layer0")(g, inputs)
        h = {k: jax.nn.relu(v) for k, v in h.items()}
        return JHeteroGraphConv(
            {et: JGraphConv(self.hidden, self.classes,
                            allow_zero_in_degree=True, name=f"l1_{et}")
             for et in self.etypes}, aggregate="sum", name="layer1")(g, h)


class HeteroRGCN(torch.nn.Module):
    """The same composition with the port's modules."""

    def __init__(self, in_feats, hidden, classes, etypes):
        super().__init__()
        self.layer0 = HeteroGraphConv(
            {et: GraphConv(in_feats, hidden, allow_zero_in_degree=True,
                           device="cpu") for et in etypes}, aggregate="sum")
        self.layer1 = HeteroGraphConv(
            {et: GraphConv(hidden, classes, allow_zero_in_degree=True,
                           device="cpu") for et in etypes}, aggregate="sum")

    def forward(self, g, inputs):
        h = {k: torch.relu(v) for k, v in self.layer0(g, inputs).items()}
        return self.layer1(g, h)


def _within_bf16_step(out, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=2.0 ** -8 * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _assert_close_up_to_bf16_flips(out, ref, what):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    bad = np.abs(out - ref) > 1e-4 * scale + 1e-4 * np.abs(ref)
    assert bad.mean() <= 1e-3, f"{what}: {bad.sum()} of {bad.size} elements"
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -8 * scale,
                               err_msg=what)


@pytest.mark.parametrize("plans", [False, True])
def test_hetero_rgcn_matches(mag, plans):
    """64 -> 16 -> 24: layer 0 applies its weight first, layer 1
    aggregates first. With ``with_spmm_plans(num_hubs=128)`` every
    relation (bipartite ones included) aggregates through its hub plan;
    ``author`` gets no input in layer 1, so only ``paper`` and ``field``
    come out."""
    jg, tg = mag
    if plans:
        jg, tg = jg.with_spmm_plans(num_hubs=128), tg.with_spmm_plans(
            num_hubs=128)
        assert all(r.hub_plan is not None for r in tg._relations.values())
    etypes = tuple(jg.etypes)
    jm = JHeteroRGCN(64, 16, 24, etypes)
    tm = HeteroRGCN(64, 16, 24, etypes)
    x = {nt: np.array(jg._node_frames[nt]["feat"]) for nt in jg.ntypes}
    params = jm.init(jax.random.PRNGKey(3), jg,
                     {k: jnp.asarray(v) for k, v in x.items()})
    # flax makes the GraphConvs children of the module that builds them,
    # l0_<etype> and l1_<etype>; layer 1's writes and affiliated_with
    # (source author, which has no input there) are never called, so flax
    # has no parameters for them, and their port modules take no part
    rename = {f"l{i}_{et}": f"layer{i}.mods.{et}" for i in (0, 1)
              for et in etypes}
    sd = dt.from_flax_params(params, rename)
    unused = {f"layer1.mods.{et}.{p}" for et in ("writes", "affiliated_with")
              for p in ("weight", "bias")}
    assert set(sd) == set(tm.state_dict()) - unused
    assert tm.load_state_dict(sd, strict=False).missing_keys == sorted(
        unused, key=list(tm.state_dict()).index)
    cot = {"paper": _rand((2000, 24), 9), "field": _rand((200, 24), 10)}
    ref, jgr, jgx = _ref_grads(
        jm, params, lambda xx: (jg, xx),
        {k: jnp.asarray(v) for k, v in x.items()},
        {k: jnp.asarray(v) for k, v in cot.items()})
    out, tgr, tgx = _port_grads(tm, lambda xx: (tg, xx), x, cot)
    assert set(out) == set(ref) == {"paper", "field"}
    close = _assert_close_up_to_bf16_flips if plans else _close
    for k in ref:
        close(out[k].detach().numpy(), ref[k], k)
    _check_grads(jgr, tgr, _within_bf16_step if plans else _close, rename)
    # the input's gradient on the f32 path only: on the hub path each
    # layer's backward rounds its f32 cotangent, computed on each side
    # with other roundings, to bf16, and an element that flips there
    # moves whole rows of the input's gradient
    if not plans:
        for k in x:
            close(tgx[k], jgx[k], f"d{k}")
