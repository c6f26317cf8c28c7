"""The port's host minibatch path against ``dgl_tpu``: fixed-shape MFG
blocks from ``FixedShapeNeighborSampler``, the uniform-stride g-SpMM and
edge softmax over them, ``GATConv`` and ``GraphSAGE`` on blocks, and
``create_block`` with the block's graph object.

Both sides sample a zipf graph of 2,000 nodes (12,000 edges, parallel
edges included) with the same numpy seed; both run ``csrc/host_ops.cpp``'s
``build_padded_block``, so their blocks are equal array for array.

Tolerances:

- Blocks, ids and masks: exact.
- Uniform g-SpMM: max and min forward exactly (the same f32 messages,
  selected); sum and mean forward and every gradient at rtol = 1e-5,
  atol = 1e-6 * max|ref| (the same f32 terms summed in another order).
- Uniform edge softmax: rtol = atol = 1e-5, forward and gradient.
- ``GATConv`` on a block, eval mode: rtol = atol = 1e-4 (f32 projections
  whose last bits differ between the frameworks, as in
  ``test_torch_gat_edge.py``).
- ``GraphSAGE`` over two blocks: logits, gradients and parameters after
  one SGD step at rtol = 1e-4, atol = 1e-5 * max|ref|.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import dgl_tpu
from dgl_tpu import ops as jops
from dgl_tpu.dataloading import FixedShapeNeighborSampler as JSampler
from dgl_tpu.models import GraphSAGE as JGraphSAGE
from dgl_tpu.nn import GATConv as JGATConv
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch import ops as tops
from dgl_tpu_torch.base import EID, NID, DGLError
from dgl_tpu_torch.dataloading import FixedShapeNeighborSampler
from dgl_tpu_torch.models import GraphSAGE
from dgl_tpu_torch.nn import GATConv

from test_torch_sampling import reference_native

N, E, BATCH, FANOUTS = 2000, 12_000, 64, [3, 5]


def _zipf(seed=0, n=N, e=E):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    return rng.choice(n, e, p=w / w.sum()), rng.integers(0, n, e)


@pytest.fixture(scope="module")
def graphs():
    src, dst = _zipf()
    return (dgl_tpu.graph((src, dst), num_nodes=N),
            dt.graph((src, dst), num_nodes=N, device="cpu"))


def _seeds(k, seed=1):
    return np.random.default_rng(seed).permutation(N)[:k]


def _both_samplers(**kw):
    return (JSampler(FANOUTS, batch_size=BATCH, seed=7, **kw),
            FixedShapeNeighborSampler(FANOUTS, BATCH, seed=7, device="cpu",
                                      **kw))


@pytest.fixture(scope="module")
def blocks(graphs):
    """One batch of 60 seeds (4 padding slots) on both sides."""
    jg, tg = graphs
    js, ts = _both_samplers()
    seeds = _seeds(BATCH - 4)
    return js.sample_blocks(jg, seeds), ts.sample_blocks(tg, seeds)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _assert_blocks_equal(jres, tres):
    jin, jout, jblocks = jres
    tin, tout, tblocks = tres
    assert tin.dtype == torch.int64 and tout.dtype == torch.int64
    np.testing.assert_array_equal(tin.numpy(), jin)
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert len(tblocks) == len(jblocks)
    for jb, tb in zip(jblocks, tblocks):
        assert tb.is_block and jb.is_block
        assert (tb.num_src_nodes(), tb.num_dst_nodes(), tb.num_edges()) == (
            jb.num_src_nodes(), jb.num_dst_nodes(), jb.num_edges())
        jr, tr = jb._relation(None), tb._relation()
        for f in dt.Relation.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)),
                                          err_msg=f)
        assert (tr.uniform_stride, tr.max_in_degree, tr.max_out_degree) == (
            jr.uniform_stride, jr.max_in_degree, jr.max_out_degree)
        for view, jframe in ((tb.srcdata, jb._node_frames["_N"]),
                             (tb.dstdata, jb._dst_frames["_N"])):
            assert view[NID].dtype == torch.int64
            assert view["_mask"].dtype == torch.bool
            np.testing.assert_array_equal(view[NID].numpy(), jframe[NID])
            np.testing.assert_array_equal(view["_mask"].numpy(),
                                          jframe["_mask"])
        jframe = jb._edge_frames[jb.canonical_etypes[0]]
        assert tb.edata[EID].dtype == torch.int64
        np.testing.assert_array_equal(tb.edata[EID].numpy(), jframe[EID])
        np.testing.assert_array_equal(tb.edata["_mask"].numpy(),
                                      jframe["_mask"])


@pytest.fixture(scope="module")
def weighted_graphs():
    """The zipf graph with edge weights ``w``, a fifth of them 0."""
    src, dst = _zipf()
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    rng = np.random.default_rng(9)
    w = rng.random(E).astype(np.float32)
    w[rng.random(E) < 0.2] = 0.0
    jg.edata["w"], tg.edata["w"] = jnp.asarray(w), torch.from_numpy(w)
    return jg, tg


@pytest.mark.parametrize("case", ["plain", "replace", "exclude", "prob",
                                  "prob_replace"])
def test_blocks_match_reference(graphs, weighted_graphs, case):
    """Two successive batches (the generator advances between them),
    without and with replacement, with excluded edges rerouted to the
    sink, and weighted by an edge feature (``sample_neighbors_prob``'s
    picks, relabelled as the reference's loop does)."""
    reference_native()
    kw = dict(replace=case.endswith("replace"))
    if case.startswith("prob"):
        jg, tg = weighted_graphs
        kw["prob"] = "w"
    else:
        jg, tg = graphs
    js, ts = _both_samplers(**kw)
    exclude = None
    if case == "exclude":
        exclude = np.random.default_rng(3).choice(E, E // 4, replace=False)
    for k, seed in ((BATCH, 1), (BATCH - 9, 2)):
        seeds = _seeds(k, seed)
        jres = js.sample_blocks(jg, seeds, exclude_eids=exclude)
        tres = ts.sample_blocks(tg, torch.from_numpy(seeds),
                                exclude_eids=exclude)
        _assert_blocks_equal(jres, tres)
        if case == "exclude":
            for tb in tres[2]:
                eids, mask = tb.edata[EID].numpy(), tb.edata["_mask"].numpy()
                assert not np.isin(eids[mask], exclude).any()


def test_block_layout(blocks):
    """The fixed shapes: cap_dst = batch + 1 at the output, cap_src =
    cap_dst * (1 + fanout), an edge slot per (dst slot, pick)."""
    _, (tin, _, tblocks) = blocks
    cap = BATCH + 1
    for tb, fanout in zip(reversed(tblocks), reversed(FANOUTS)):
        rel = tb._relation()
        assert tb.num_dst_nodes() == cap
        assert tb.num_src_nodes() == cap * (1 + fanout) == rel.num_src
        assert tb.num_edges() == cap * fanout == rel.num_edges_padded
        assert rel.uniform_stride == fanout
        assert tb.srcdata[NID].shape == (cap * (1 + fanout),)
        assert tb.dstdata[NID].shape == (cap,)
        cap = cap * (1 + fanout)
    assert tin.shape == (cap,)


def test_sampler_refuses(graphs):
    _, tg = graphs
    with pytest.raises(DGLError, match="batch_size"):
        FixedShapeNeighborSampler([2], 4, device="cpu").sample_blocks(
            tg, np.arange(5))
    # a weight the graph does not hold (the reference draws uniformly in
    # numpy then, which the port does not reproduce)
    with pytest.raises(DGLError, match="'w' not found"):
        FixedShapeNeighborSampler([2], 4, prob="w", device="cpu"
                                  ).sample_blocks(tg, np.arange(3))
    with pytest.raises(ValueError, match="out of range"):
        FixedShapeNeighborSampler([2], 4, device="cpu").sample_blocks(
            tg, np.array([3, N]))


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with the compiler's output; nothing
    falls back."""
    from dgl_tpu_torch import _host

    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_host, "SOURCE", str(bad))
    monkeypatch.setattr(_host, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*error"):
        _host._compile()


# ---------------------------------------------------------------------------
# the uniform-stride g-SpMM and edge softmax
# ---------------------------------------------------------------------------


def _inner(blocks):
    """The innermost block's relations (fanout 3, 390 dst slots)."""
    (_, _, jblocks), (_, _, tblocks) = blocks
    return jblocks[0]._relation(None), tblocks[0]._relation()


def _close(got, want, exact=False):
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def _operands(jrel, op, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(jrel.num_src, 4)).astype(np.float32)
    e = rng.uniform(0.5, 1.5, size=(jrel.num_dst * jrel.uniform_stride,
                                    4)).astype(np.float32)
    return (u if op != "copy_rhs" else None,
            e if op != "copy_lhs" else None)


def _gspmm_both(jrel, trel, op, reduce_op, u, e, cot):
    """Forward and the gradients of sum(out * cot) on both sides."""
    args = [a for a in (u, e) if a is not None]

    def jfn(*a):
        it = iter(a)
        return jops.gspmm(jrel, op, reduce_op,
                          next(it) if u is not None else None,
                          next(it) if e is not None else None)

    jout, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = pull(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    it = iter(targs)
    tout = tops.gspmm(trel, op, reduce_op,
                      next(it) if u is not None else None,
                      next(it) if e is not None else None)
    (tout * torch.from_numpy(cot)).sum().backward()
    return jout, jgrads, tout, [a.grad for a in targs]


@pytest.mark.parametrize("reduce_op", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("op", ["copy_lhs", "copy_rhs", "add", "sub", "mul",
                                "div"])
def test_uniform_gspmm_matches(blocks, op, reduce_op):
    jrel, trel = _inner(blocks)
    assert trel.uniform_stride == 3
    u, e = _operands(jrel, op, 5)
    cot = np.random.default_rng(6).normal(
        size=(jrel.num_dst, 4)).astype(np.float32)
    jout, jgrads, tout, tgrads = _gspmm_both(jrel, trel, op, reduce_op, u,
                                             e, cot)
    assert tout.shape == (trel.num_dst, 4)
    _close(tout.detach().numpy(), jout, exact=reduce_op in ("max", "min"))
    for g, r in zip(tgrads, jgrads):
        _close(g.numpy(), r)


@pytest.mark.parametrize("reduce_op", ["mean", "max"])
def test_uniform_guard_falls_through(graphs, reduce_op):
    """A relation with a stride but fewer edges than ``num_dst * stride``
    takes the other branches, as in the reference (``spmm.py:236-241``)."""
    jg, tg = graphs
    jrel, trel = jg._relation(None), tg._relation()
    stride = E // N + 1
    assert N * stride > E
    jrel = copy.copy(jrel)
    jrel.uniform_stride = stride
    x = np.random.default_rng(8).normal(size=(N, 3)).astype(np.float32)
    out = tops.gspmm(trel._copy_with(uniform_stride=stride), "copy_lhs",
                     reduce_op, torch.from_numpy(x), None)
    _close(out.numpy(), jops.gspmm(jrel, "copy_lhs", reduce_op, x, None),
           exact=reduce_op == "max")
    plain = tops.gspmm(trel, "copy_lhs", reduce_op, torch.from_numpy(x),
                       None)
    np.testing.assert_array_equal(out.numpy(), plain.numpy())


@pytest.mark.parametrize("feat", [(), (3, 1)])
def test_uniform_edge_softmax_matches(blocks, feat):
    """A block's relation has exactly ``num_dst * stride`` edges, the case
    the reference's branch (no guard) requires. Stripes without a valid
    slot (padding dst slots) give 0 in the port; the reference's floor
    ``max(sum, 1e-38)`` is a subnormal that XLA's CPU flushes to 0, so it
    gives 0/0 = NaN there (ROADMAP queue C). Every other stripe, its
    padding slots included, agrees."""
    jrel, trel = _inner(blocks)
    f = trel.uniform_stride
    assert trel.num_edges_padded == trel.num_dst * f
    rng = np.random.default_rng(9)
    x = rng.normal(size=(trel.num_edges_padded,) + feat).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    jout, pull = jax.vjp(lambda a: jops.edge_softmax(jrel, a),
                         jnp.asarray(x))
    (jgrad,) = pull(jnp.asarray(cot))
    tx = torch.from_numpy(x).requires_grad_()
    tout = tops.edge_softmax(trel, tx)
    (tout * torch.from_numpy(cot)).sum().backward()
    valid = trel.dst.numpy() == np.repeat(np.arange(trel.num_dst), f)
    live = np.repeat(valid.reshape(-1, f).any(1), f)
    assert live.any() and not live.all()
    assert np.isnan(np.asarray(jout)[~live]).all()
    tol = dict(rtol=1e-5, atol=1e-5)
    for got, want in ((tout.detach().numpy(), jout), (tx.grad.numpy(),
                                                      jgrad)):
        assert not got[~live].any() and not got[~valid].any()
        np.testing.assert_allclose(got[live], np.asarray(want)[live], **tol)


# ---------------------------------------------------------------------------
# layers and models on blocks
# ---------------------------------------------------------------------------


def test_gatconv_on_block_matches(blocks):
    """The per-edge route (no plan on a block) through the uniform edge
    softmax and g-SpMM; padded dst slots have no in-edge."""
    (_, _, jblocks), (_, _, tblocks) = blocks
    jb, tb = jblocks[0], tblocks[0]
    x = np.random.default_rng(10).normal(
        size=(tb.num_src_nodes(), 12)).astype(np.float32)
    jm = JGATConv(12, 5, 2, allow_zero_in_degree=True)
    params = jm.init(jax.random.PRNGKey(3), jb, jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jb, jnp.asarray(x)))
    tm = GATConv(12, 5, 2, allow_zero_in_degree=True, device="cpu")
    tm.load_state_dict(dt.from_flax_params(params))
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = tm.eval()(tb, torch.from_numpy(x))
    assert not any(_kernels.launch_counts.values())
    assert out.shape == (tb.num_dst_nodes(), 2, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(DGLError, match="0-in-degree"):
        GATConv(12, 5, 2, device="cpu")(tb, torch.from_numpy(x))


def _bench_inputs(tblocks, seed):
    """bench.py's step inputs: the innermost frontier's features (padding
    rows zeroed), the output slots' labels and mask."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(N, 10)).astype(np.float32)
    labels = rng.integers(0, 4, N)
    in_ids = tblocks[0].srcdata[NID].numpy()
    in_mask = tblocks[0].srcdata["_mask"].numpy()
    out_ids = tblocks[-1].dstdata[NID].numpy()
    out_mask = tblocks[-1].dstdata["_mask"].numpy()
    return (feats[in_ids] * in_mask[:, None], labels[out_ids].astype(np.int32),
            out_mask.astype(np.float32))


def test_graphsage_minibatch_step_matches(blocks):
    """One ``sage_minibatch`` step (bench.py:388-495) on both sides: the
    logits, every gradient and the parameters after ``optax.sgd`` /
    ``torch.optim.SGD`` at 1e-3, with the reference's weights carried over
    by ``from_flax_params``."""
    (_, _, jblocks), (_, _, tblocks) = blocks
    x, y, m = _bench_inputs(tblocks, 11)
    jm = JGraphSAGE(10, 16, 4, num_layers=2, dropout=0.0)
    params = jm.init(jax.random.PRNGKey(0), jblocks, jnp.asarray(x))

    def jloss(p):
        logits = jm.apply(p, jblocks, jnp.asarray(x))
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y))
        return (ls * m).sum() / jnp.maximum(m.sum(), 1), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tx = optax.sgd(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params))
    jnew = optax.apply_updates(params, upd)

    tm = GraphSAGE(10, 16, 4, num_layers=2, dropout=0.0, device="cpu")
    tm.load_state_dict(dt.from_flax_params(params))
    opt = torch.optim.SGD(tm.parameters(), lr=1e-3)
    logits = tm(tblocks, torch.from_numpy(x))
    tmask = torch.from_numpy(m)
    ce = F.cross_entropy(logits, torch.from_numpy(y).long(),
                         reduction="none")
    loss = (ce * tmask).sum() / torch.clamp(tmask.sum(), min=1)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)

    assert logits.shape == (BATCH + 1, 4)
    close(logits.detach().numpy(), jlogits, "logits")
    close(loss.item(), jl, "loss")
    for tree, got in ((jgrads, grads),
                      (jnew, dict(tm.state_dict()))):
        want = dt.from_flax_params(tree)
        assert set(got) == set(want)
        for k, v in got.items():
            close(v.detach().numpy(), want[k].numpy(), k)


# ---------------------------------------------------------------------------
# create_block and the block's graph object
# ---------------------------------------------------------------------------


def test_create_block_matches_reference():
    src, dst = np.array([0, 3, 4, 4, 1]), np.array([0, 1, 1, 2, 0])
    jb = dgl_tpu.create_block((src, dst), num_src_nodes=6, num_dst_nodes=3)
    forms = [
        dt.create_block((src, dst), num_src_nodes=6, num_dst_nodes=3,
                        device="cpu"),
        dt.create_block({("_N", "_E", "_N"): (torch.from_numpy(src), dst)},
                        num_src_nodes={"_N": 6}, num_dst_nodes={"_N": 3},
                        device="cpu"),
    ]
    for tb in forms:
        assert tb.is_block
        assert (tb.num_src_nodes(), tb.num_dst_nodes(), tb.num_nodes()) == (
            6, 3, 6)
        jr, tr = jb._relation(None), tb._relation()
        for f in dt.Relation.ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                          np.asarray(getattr(jr, f)))
    inferred = dt.create_block((src, dst), device="cpu")
    assert (inferred.num_src_nodes(), inferred.num_dst_nodes()) == (5, 3)
    padded = dt.create_block((np.append(src, 6), np.append(dst, 3)), 6, 3,
                             num_edges=5, device="cpu")
    assert padded.num_edges() == 5
    assert padded._relation().num_edges_padded == 6
    # blocks between node types and of several edge types run since the
    # heterogeneous slice (they raised before it): the reference's counts
    # and arrays
    for data in ({("u", "e", "v"): (src, dst)},
                 {("_N", "a", "_N"): (src, dst),
                  ("_N", "b", "_N"): (dst, src)}):
        jb = dgl_tpu.create_block(data)
        tb = dt.create_block(data, device="cpu")
        assert tb.canonical_etypes == jb.canonical_etypes
        assert tb.ntypes == jb.ntypes
        for cet in jb.canonical_etypes:
            assert (tb.num_src_nodes(cet[0]), tb.num_dst_nodes(cet[2])) == (
                jb.num_src_nodes(cet[0]), jb.num_dst_nodes(cet[2]))
            for f in dt.Relation.ARRAY_FIELDS:
                np.testing.assert_array_equal(
                    getattr(tb._relation(cet), f).numpy(),
                    np.asarray(getattr(jb._relation(cet), f)))


def test_block_frames():
    """``srcdata`` and ``dstdata`` are separate frames with their own row
    counts; ``update_all`` writes ``num_dst`` rows into the dst frame;
    ``local_scope``, ``.to`` and ``structural_clone`` keep the dst frame;
    a relation's stride survives ``.to``."""
    src, dst = np.array([0, 3, 4, 4, 1]), np.array([0, 1, 1, 2, 0])
    b = dt.create_block((src, dst), 6, 3, device="cpu")
    b.srcdata["h"] = torch.arange(6.0)[:, None]
    b.dstdata["d"] = torch.ones(3, 2)
    assert "d" not in b.srcdata and "h" not in b.dstdata
    assert b.ndata["h"] is b.srcdata["h"]
    with pytest.raises(DGLError, match="dst nodes 3"):
        b.dstdata["x"] = torch.ones(6)
    with pytest.raises(DGLError, match="nodes 6"):
        b.srcdata["x"] = torch.ones(3)
    with b.local_scope():
        b.update_all(dt.function.copy_u("h", "m"), dt.function.sum("m", "s"))
        assert b.dstdata["s"].shape == (3, 1)
        assert b.dstdata["s"][:, 0].tolist() == [1.0, 7.0, 4.0]
        assert "s" not in b.srcdata
    assert "s" not in b.dstdata and "d" in b.dstdata
    b.apply_nodes(lambda nodes: {"d2": nodes.data["d"] * 2})
    assert b.dstdata["d2"].shape == (3, 2) and "d2" not in b.srcdata
    for g in (b.to("cpu"), b.structural_clone()):
        assert g.is_block and g.dstdata["d"].shape == (3, 2)
        assert g.srcdata["h"].shape == (6, 1)
    rel = b._relation()
    rel.uniform_stride = 2
    assert rel.to("cpu").uniform_stride == 2
    assert b.to("cpu")._relation().uniform_stride == 2
    g = dt.graph((src, dst), num_nodes=6, device="cpu")
    g.dstdata["x"] = torch.ones(6)
    assert not g.is_block and g.ndata["x"] is g.srcdata["x"]
