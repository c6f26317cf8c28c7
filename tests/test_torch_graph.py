"""Parity of the port's graph core with ``dgl_tpu``: the ten Relation
arrays, in-degrees and the ``reorder_for_spmm`` permutation, all exact."""
import copy

import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.transforms as jtf
from dgl_tpu.transforms.functional import reorder_graph as j_reorder_graph
import dgl_tpu_torch as dt
from dgl_tpu_torch.transforms import reorder_for_spmm, reorder_graph


def _edges(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "multi":  # many parallel edges on few nodes
        n = 40
        src, dst = rng.integers(0, n, 600), rng.integers(0, n, 600)
    elif kind == "isolated":  # most nodes have no edge at all
        n = 1000
        src, dst = rng.integers(0, 50, 300), rng.integers(20, 90, 300)
    elif kind == "zipf":
        n = 3000
        w = 1.0 / np.arange(1, n + 1)
        src, dst = rng.choice(n, 20000, p=w / w.sum()), rng.integers(0, n, 20000)
    else:  # "empty"
        n = 7
        src = dst = np.zeros(0, np.int64)
    return src, dst, n


def _assert_rel_equal(jrel, trel):
    for f in dgl_tpu.Relation.ARRAY_FIELDS:
        a = np.asarray(getattr(jrel, f))
        b = getattr(trel, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("num_src", "num_dst", "num_edges", "max_in_degree",
              "max_out_degree"):
        assert getattr(jrel, f) == getattr(trel, f), f


@pytest.mark.parametrize("kind", ["multi", "isolated", "zipf", "empty"])
def test_relation_arrays_exact(kind):
    src, dst, n = _edges(kind, 0)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    _assert_rel_equal(jg._relation(), tg._relation())
    np.testing.assert_array_equal(np.asarray(jg.in_degrees()),
                                  tg.in_degrees().numpy())
    assert tg.num_nodes() == jg.num_nodes()
    assert tg.num_edges() == jg.num_edges()


def test_padded_relation_exact():
    """Trailing edges marked as padding point at the virtual sink rows."""
    rng = np.random.default_rng(3)
    n, e, pad = 100, 700, 57
    src = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    jg = dgl_tpu.graph((src, dst), num_nodes=n, num_edges=e)
    tg = dt.graph((src, dst), num_nodes=n, num_edges=e, device="cpu")
    _assert_rel_equal(jg._relation(), tg._relation())
    np.testing.assert_array_equal(np.asarray(jg.in_degrees()),
                                  tg.in_degrees().numpy())


def test_reorder_graph_custom_exact():
    src, dst, n = _edges("zipf", 1)
    perm = np.random.default_rng(2).permutation(n)
    feat = np.random.default_rng(4).normal(size=(n, 3)).astype(np.float32)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    jg.ndata["x"] = feat
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    tg.ndata["x"] = torch.from_numpy(feat)
    cfg = {"nodes_perm": perm}
    j2 = j_reorder_graph(jg, "custom", permute_config=cfg)
    t2 = reorder_graph(tg, "custom", permute_config=cfg)
    _assert_rel_equal(j2._relation(), t2._relation())
    np.testing.assert_array_equal(np.asarray(j2.ndata["x"]),
                                  t2.ndata["x"].numpy())
    np.testing.assert_array_equal(np.asarray(j2.ndata[dgl_tpu.NID]),
                                  t2.ndata[dt.NID].numpy())


@pytest.mark.parametrize("kind,num_hubs", [("zipf", 128), ("multi", 128),
                                           ("isolated", 256)])
def test_reorder_for_spmm_permutation_exact(kind, num_hubs):
    src, dst, n = _edges(kind, 5)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    j2, jperm = jtf.reorder_for_spmm(jg, num_hubs=num_hubs, precision="int8")
    t2, tperm = reorder_for_spmm(tg, num_hubs=num_hubs, precision="int8")
    np.testing.assert_array_equal(jperm, tperm)
    _assert_rel_equal(j2._relation(), t2._relation())
    assert t2._relation().hub_plan.unrank_dst is None
    assert j2._relation().hub_plan.unrank_dst is None


def test_update_all_mean_no_plan_matches():
    """``update_all(copy_u, mean)`` on the plain path (no plan)."""
    import dgl_tpu.function as jfn
    import dgl_tpu_torch.function as tfn

    src, dst, n = _edges("isolated", 6)
    x = np.random.default_rng(7).normal(size=(n, 5)).astype(np.float32)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    jg.ndata["h"] = x
    tg.ndata["h"] = torch.from_numpy(x)
    jg.update_all(jfn.copy_u("h", "m"), jfn.mean("m", "o"))
    tg.update_all(tfn.copy_u("h", "m"), tfn.mean("m", "o"))
    np.testing.assert_allclose(np.asarray(jg.ndata["o"]),
                               tg.ndata["o"].numpy(), rtol=1e-6, atol=1e-6)


def test_u_mul_e_sum_no_plan_matches():
    src, dst, n = _edges("multi", 8)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=(src.shape[0],)).astype(np.float32)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    ref = dgl_tpu.ops.u_mul_e_sum(jg, x, w)
    out = dt.ops.u_mul_e_sum(tg, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_later_slices_raise():
    src, dst, n = _edges("multi", 0)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    x = np.random.default_rng(1).normal(size=(n, 2)).astype(np.float32)
    rel = tg._relation()
    # the uniform-stride branch runs since the minibatch slice: with a
    # stride set on a graph's relation, the reference's values, whichever
    # branch its guard picks
    jrel = copy.copy(jg._relation(None))
    jrel.uniform_stride = 4
    np.testing.assert_array_equal(
        dt.ops.copy_u_max(rel._copy_with(uniform_stride=4),
                          torch.from_numpy(x)).numpy(),
        np.asarray(dgl_tpu.ops.copy_u_max(jrel, x)))
    # the max reducer runs since the message-passing slice: the
    # reference's values, parallel edges included
    np.testing.assert_allclose(
        dt.ops.copy_u_max(tg, torch.from_numpy(x)).numpy(),
        np.asarray(dgl_tpu.ops.copy_u_max(jg, x)), rtol=1e-6, atol=1e-6)
    # the weighted shell plan runs since the weighted g-SpMM slice: on this
    # multigraph, the reference's plan array for array
    jsp = jg.with_spmm_plans(weighted=True)._relation(None).shell_plan
    tsp = tg.with_spmm_plans(weighted=True)._relation().shell_plan
    for f in jsp.ARRAY_FIELDS:
        ja, ta = getattr(jsp, f), getattr(tsp, f)
        if f in ("shells", "rev_shells"):
            ja = [a for lvl in ja for a in lvl]
            ta = [a for lvl in ta for a in lvl]
        elif f in ("res_dst", "res_src") and ja is not None:
            ja, ta = list(ja), list(ta)
        else:
            ja, ta = [ja], [ta]
        assert len(ja) == len(ta), f
        for a, b in zip(ja, ta):
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # multi-edges: neither a bitmap plan nor the dense mask attaches,
    # forced or not, as in the reference
    for kw in ({}, {"bitmap": True, "dense_attn": True}):
        rel = tg.with_spmm_plans(num_hubs=128, **kw)._relation()
        assert rel.hub_plan is not None and rel.bitmap_plan is None
        assert rel.dense_adj is None
        jrel = jg.with_spmm_plans(num_hubs=128, **kw)._relation()
        assert jrel.bitmap_plan is None and jrel.dense_adj is None
