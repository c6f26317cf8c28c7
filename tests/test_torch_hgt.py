"""The port's ``HGTConv`` and an HGT model built from the port's modules
against ``dgl_tpu``.

- ``HGTConv(8, 4, 2, 2, 3)`` at the size of the reference's own test
  (``tests/test_nn_extra.py:164``: 20 nodes, 140 edges), with
  ``use_norm``, with ``in_size != H * D`` (no skip), with 12 relations
  (more rows times relations than edges: the per-edge ``gather_mm`` route
  of ``relation_rows``) and on a graph with padded edges;
- ``relation_rows``' two routes against the reference's per-edge
  (E, H, D, D) product;
- the HGT of DGL's example (``examples/pytorch/hgt/model.py``): per-type
  input adapters (``HeteroLinear``, exact GELU on both sides), the node
  types concatenated in ``to_homogeneous``'s order, two ``HGTConv``
  layers with ``use_norm``, a linear classifier on the paper rows; on
  ``to_homogeneous`` of the ogbn-mag recipe at 1/2000 of its counts
  (``chip_smoke.mag_graph``), at narrow widths.

Forward values and the gradients of ``sum(out * cot)`` for the input and
every parameter (the reference's from ``jax.grad`` under ``jax.jit``),
dropout off, the parameters carried over by ``from_flax_params`` (the
(R, H, D, D) tensors unchanged). Tolerance: rtol = 1e-4,
atol = 1e-4 * max|ref| (the same f32 operations, sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import chip_smoke
import dgl_tpu
from dgl_tpu.nn.conv import HGTConv as JHGTConv
from dgl_tpu.nn.linear import HeteroLinear as JHeteroLinear
import dgl_tpu_torch as dt
from dgl_tpu_torch.nn import HGTConv
from dgl_tpu_torch.nn.conv.hgtconv import relation_rows

RTOL = 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _graphs(padded=False):
    """The reference test's graph: 120 random edges on 20 nodes plus a
    self-loop each; with ``padded``, 9 padded edges after them."""
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, 20, 120), np.arange(20)])
    dst = np.concatenate([rng.integers(0, 20, 120), np.arange(20)])
    kw = {}
    if padded:
        kw = dict(num_edges=140)
        src = np.concatenate([src, np.full(9, 20)])
        dst = np.concatenate([dst, np.full(9, 20)])
    return (dgl_tpu.graph((src, dst), num_nodes=20, **kw),
            dt.graph((src, dst), num_nodes=20, device="cpu", **kw))


def _run_both(jmod, tmod, jargs, targs, x, cot):
    """Output and gradients of ``sum(out * cot)`` on both sides; the
    reference's parameters are loaded into the port's module first."""
    params = jax.jit(lambda k, xx: jmod.init(k, *jargs(xx)))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tmod.state_dict())
    tmod.load_state_dict(sd)

    def loss(p, xx):
        out = jmod.apply(p, *jargs(xx))
        return jnp.sum(out * cot), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tmod(*targs(xt))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    _close(xt.grad.numpy(), gx, "dx")
    _check_grads(gp, tmod)
    return sd


def _check_grads(jgrads, model):
    """Every parameter's gradient; one that reaches no output (``skip``
    without the skip) has none here and zeros in JAX."""
    want = dt.from_flax_params(jgrads)
    got = {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None
           else p.grad.numpy() for k, p in model.named_parameters()}
    assert set(want) == set(got)
    for k, v in want.items():
        _close(got[k], v.numpy(), f"grad {k}")


@pytest.mark.parametrize("in_size,num_etypes,use_norm,padded", [
    (8, 3, False, False),   # the reference test's layer: skip, row route
    (8, 3, True, False),    # use_norm: flax's LayerNorm, epsilon 1e-6
    (6, 3, True, False),    # in_size != H * D: no skip
    (8, 12, False, False),  # 12 * 20 rows > 140 edges: the edge route
    (8, 3, True, True),     # padded edges carry nothing
])
def test_hgtconv_matches(in_size, num_etypes, use_norm, padded):
    """With padded edges the port is held against the reference on the
    graph without them: the reference's output is the same there, but
    its gradients are not, since its backward gathers the cotangent of
    the last row (clamped) onto the padded edges' messages."""
    jg, tg = _graphs(padded)
    E = tg._relation().num_edges_padded
    ntype = np.random.default_rng(5).integers(0, 2, 20)
    etype = np.random.default_rng(6).integers(0, num_etypes, E)
    jmod = JHGTConv(in_size, 4, 2, 2, num_etypes, use_norm=use_norm)
    tmod = HGTConv(in_size, 4, 2, 2, num_etypes, use_norm=use_norm,
                   device="cpu").eval()
    x, cot = _rand((20, in_size), 1), _rand((20, 8), 2)
    jref = _graphs()[0] if padded else jg
    sd = _run_both(
        jmod, tmod,
        lambda xx: (jref, xx, jnp.asarray(ntype), jnp.asarray(etype[:140])),
        lambda xx: (tg, xx, torch.from_numpy(ntype),
                    torch.from_numpy(etype)), x, cot)
    # the (R, H, D, D) tensors carry over unchanged
    assert tuple(sd["relation_att"].shape) == (num_etypes, 2, 4, 4)
    if use_norm:
        assert tmod.norm.eps == 1e-6
    if padded:
        params = {"params": jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.detach().numpy()),
            _flax_tree(tmod.state_dict()))}
        ref = jax.jit(lambda p: jmod.apply(
            p, jg, jnp.asarray(x), jnp.asarray(ntype),
            jnp.asarray(etype)))(params)
        _close(tmod(tg, torch.from_numpy(x), torch.from_numpy(ntype),
                    torch.from_numpy(etype)).detach().numpy(), ref,
               "out, padded reference")


def _flax_tree(sd):
    """The port's HGTConv state as the reference's parameter tree."""
    tree = {}
    for k, v in sd.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node["scale" if path == ["norm"] and leaf == "weight" else leaf] = v
    return tree


@pytest.mark.parametrize("num_rel,num_edges", [(3, 500), (40, 300)])
def test_relation_rows_routes(num_rel, num_edges):
    """Both routes (rows times relations first when ``R * N <= E``, else
    per edge) give the reference's ``einsum("ehd,ehdf->ehf", x[src],
    w[etype])``, and their gradients."""
    rng = np.random.default_rng(num_rel)
    N, H, D, F = 30, 3, 5, 4
    x, w = _rand((N, H, D), 1), _rand((num_rel, H, D, F), 2)
    src = rng.integers(0, N, num_edges)
    et = rng.integers(0, num_rel, num_edges)
    cot = _rand((num_edges, H, F), 3)
    ref, vjp = jax.vjp(
        lambda a, b: jnp.einsum("ehd,ehdf->ehf", a[src], b[et]),
        jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = relation_rows(xt, wt, torch.from_numpy(src), torch.from_numpy(et))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "rows")
    _close(xt.grad.numpy(), gx, "dx")
    _close(wt.grad.numpy(), gw, "dw")


def test_hgt_init_distribution():
    """flax's ``xavier_uniform`` on (R, H, D, D) counts the leading axes
    into both fans: the bound is sqrt(6 / (2 * D * R * H))."""
    m = HGTConv(256, 64, 4, 4, 4, generator=torch.Generator().manual_seed(
        0), device="cpu")
    bound = (6.0 / (2 * 64 * 4 * 4)) ** 0.5
    for w in (m.relation_att, m.relation_msg):
        assert 0.99 * bound < w.abs().max().item() <= bound
    assert (m.relation_pri == 1).all() and (m.skip == 1).all()


# ---------------------------------------------------------------------------
# the whole HGT model
# ---------------------------------------------------------------------------


class JHGT(fnn.Module):
    """The reference side of ``chip_smoke.hgt_model``."""

    ntypes: tuple
    in_feats: int
    head_size: int
    heads: int
    num_etypes: int
    classes: int
    n_out: int

    @fnn.compact
    def __call__(self, g, feats, ntype, etype):
        hid = self.head_size * self.heads
        h = JHeteroLinear({nt: self.in_feats for nt in self.ntypes}, hid,
                          name="adapt")(feats)
        h = jnp.concatenate([jax.nn.gelu(h[nt], approximate=False)
                             for nt in self.ntypes])
        for i in range(2):
            h = JHGTConv(hid, self.head_size, self.heads, len(self.ntypes),
                         self.num_etypes, use_norm=True,
                         name=f"layer{i}")(g, h, ntype, etype)
        return fnn.Dense(self.classes, name="out")(h[:self.n_out])


def test_hgt_model_matches():
    mag = chip_smoke.mag_graph(2000, seed=3)
    hg = dt.heterograph(mag["data"], mag["nodes"], device="cpu")
    th = dt.to_homogeneous(hg)
    src, dst = (t.numpy() for t in th.edges())
    jh = dgl_tpu.graph((src, dst), num_nodes=th.num_nodes())
    ntypes = tuple(hg.ntypes)
    ntype = th.ndata[dt.NTYPE].numpy()
    etype = th.edata[dt.ETYPE].numpy()
    n_paper = mag["nodes"]["paper"]
    F, D, H, C = 8, 4, 4, 7
    feats = {nt: mag["feats"][nt][:, :F].copy() for nt in ntypes}
    jm = JHGT(ntypes, F, D, H, len(hg.canonical_etypes), C, n_paper)
    tm = chip_smoke.hgt_model(ntypes, F, D, H, len(hg.canonical_etypes), C,
                              n_paper, dropout=0.2, seed=0,
                              device="cpu").eval()
    jargs = (jh, {k: jnp.asarray(v) for k, v in feats.items()},
             jnp.asarray(ntype), jnp.asarray(etype))
    params = jax.jit(lambda k, ff: jm.init(k, jh, ff, *jargs[2:]))(
        jax.random.PRNGKey(1), jargs[1])
    sd = dt.from_flax_params(params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    cot = _rand((n_paper, C), 4)

    def loss(p, ff):
        out = jm.apply(p, jh, ff, jargs[2], jargs[3])
        return jnp.sum(out * cot), out

    (_, ref), (gp, gf) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jargs[1])
    ft = {k: torch.from_numpy(v).requires_grad_() for k, v in feats.items()}
    out = tm(th, ft, torch.from_numpy(ntype), torch.from_numpy(etype))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref, "out")
    for k in feats:
        _close(ft[k].grad.numpy(), gf[k], f"d{k}")
    _check_grads(gp, tm)
