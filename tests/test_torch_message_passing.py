"""The port's per-edge message-passing layer against ``dgl_tpu``: segment
ops, ``gather_mm``, every g-SDDMM op and target pair, ``edge_softmax``,
the max/min g-SpMM, and ``core``'s lowering, UDFs and ``apply_edges`` /
``apply_nodes`` subsets. Forward values and gradients (the reference's
through ``jax.vjp``), all on small graphs built with numpy from a seed.

Tolerance: rtol = atol = 1e-5 in f32. Both sides compute the same f32
operations; sums (segment sums, the ``dot`` lane sum, softmax
denominators) run in other orders, a few ulps apart.

Max and min: the inputs have no ties (continuous random values on graphs
without multi-edges). With ties, both sides split the gradient of a tied
extremum evenly among the tied messages (``scatter_reduce``'s rule; JAX's
scatter-extremal JVP averages them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.function as jfn
from dgl_tpu import ops as jops
import dgl_tpu_torch as dt
import dgl_tpu_torch.function as tfn
from dgl_tpu_torch import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)
N = 60


def _graph(kind="simple", seed=0, n=N):
    """``simple``: distinct (src, dst) pairs, the last 10 nodes with no
    in-edge. ``padded``: the same edges plus 23 padding edges at the sink
    rows. ``multi``: parallel edges."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 500), rng.integers(0, n - 10, 500)
    if kind != "multi":
        pair = np.unique(dst * n + src)
        perm = rng.permutation(pair.size)  # eid order unsorted
        src, dst = pair[perm] % n, pair[perm] // n
    kw = dict(num_nodes=n)
    if kind == "padded":
        e = src.size
        src = np.concatenate([src, np.full(23, n)])
        dst = np.concatenate([dst, np.full(23, n)])
        kw["num_edges"] = e
    return dgl_tpu.graph((src, dst), **kw), dt.graph((src, dst), device="cpu",
                                                     **kw)


def _rand(shape, seed, positive=False):
    r = np.random.default_rng(seed)
    v = r.random(shape) + 0.5 if positive else r.normal(size=shape)
    return v.astype(np.float32)


def _jvp(f, args, dz):
    out, vjp = jax.vjp(f, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dz))]


def _tvp(f, args, dz):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = f(*ts)
    out.backward(torch.from_numpy(dz))
    return out.detach().numpy(), [
        np.zeros_like(a) if t.grad is None else t.grad.numpy()
        for a, t in zip(args, ts)]


def _check(jf, tf, args, out_seed=99):
    """Forward and every input's gradient, the port against the
    reference."""
    ref = np.asarray(jf(*[jnp.asarray(a) for a in args]))
    dz = _rand(ref.shape, out_seed)
    jout, jgrads = _jvp(jf, args, dz)
    tout, tgrads = _tvp(tf, args, dz)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, **TOL)
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        np.testing.assert_allclose(a, b, err_msg=f"grad {i}", **TOL)


# ---------------------------------------------------------------------------
# segment ops and gather_mm
# ---------------------------------------------------------------------------

SEGLEN = np.array([3, 0, 5, 1, 0, 7, 2], np.int64)


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min"])
def test_segment_reduce(reducer):
    """Empty segments (lengths 0) give 0 for every reducer."""
    v = _rand((int(SEGLEN.sum()), 3, 2), 1)
    js, ts = jnp.asarray(SEGLEN.astype(np.int32)), torch.from_numpy(SEGLEN)
    _check(lambda x: jops.segment_reduce(js, x, reducer),
           lambda x: tops.segment_reduce(ts, x, reducer), [v])
    out = tops.segment_reduce(ts, torch.from_numpy(v), reducer)
    assert not out[torch.from_numpy(SEGLEN == 0)].any()


def test_segment_softmax():
    v = _rand((int(SEGLEN.sum()), 4), 2)
    js, ts = jnp.asarray(SEGLEN.astype(np.int32)), torch.from_numpy(SEGLEN)
    _check(lambda x: jops.segment_softmax(js, x),
           lambda x: tops.segment_softmax(ts, x), [v])


def test_segment_mm_and_gather_mm():
    seglen = np.array([4, 0, 6, 3], np.int64)
    a, b = _rand((13, 5), 3), _rand((4, 5, 7), 4)
    js = jnp.asarray(seglen.astype(np.int32))
    ts = torch.from_numpy(seglen)
    _check(lambda a, b: jops.segment_mm(a, b, js),
           lambda a, b: tops.segment_mm(a, b, ts), [a, b])
    idx = np.random.default_rng(5).integers(0, 4, 13)
    ji, ti = jnp.asarray(idx.astype(np.int32)), torch.from_numpy(idx)
    _check(lambda a, b: jops.gather_mm(a, b, ji),
           lambda a, b: tops.gather_mm(a, b, ti), [a, b])


# ---------------------------------------------------------------------------
# g-SDDMM: every op and target pair
# ---------------------------------------------------------------------------

PAIRS = [(l, r) for l in "uve" for r in "uve" if l != r]


def _operand(g, target, feat, seed, positive=False):
    rows = g.num_nodes() if target != "e" else g._relation().src.shape[0]
    return _rand((rows,) + feat, seed, positive)


@pytest.mark.parametrize("kind", ["simple", "padded"])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot"])
@pytest.mark.parametrize("lt,rt", PAIRS, ids=[l + r for l, r in PAIRS])
def test_gsddmm(kind, op, lt, rt):
    """``lhs`` (.., 3, 4) against a broadcast ``rhs`` (.., 1, 4), or the
    same shape for ``dot``; ``div``'s denominator kept away from 0."""
    jg, tg = _graph(kind, seed=1)
    lhs = _operand(tg, lt, (3, 4), 11)
    rhs = _operand(tg, rt, (3, 4) if op == "dot" else (1, 4), 12,
                   positive=op == "div")
    _check(lambda a, b: jops.gsddmm(jg, op, a, b, lt, rt),
           lambda a, b: tops.gsddmm(tg, op, a, b, lt, rt), [lhs, rhs])
    name = f"{lt}_{op}_{rt}"
    out = getattr(tops, name)(tg, torch.from_numpy(lhs),
                              torch.from_numpy(rhs))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(getattr(jops, name)(jg, jnp.asarray(lhs),
                                                    jnp.asarray(rhs))), **TOL)


@pytest.mark.parametrize("kind", ["simple", "padded"])
@pytest.mark.parametrize("target", ["u", "v", "e"])
def test_gsddmm_copy(kind, target):
    jg, tg = _graph(kind, seed=2)
    x = _operand(tg, target, (2, 3), 13)
    _check(lambda a: jops.gsddmm(jg, "copy_lhs", a, None, target),
           lambda a: tops.gsddmm(tg, "copy_lhs", a, None, target), [x])
    _check(lambda a: jops.gsddmm(jg, "copy_rhs", None, a, "u", target),
           lambda a: tops.gsddmm(tg, "copy_rhs", None, a, "u", target), [x])
    if target != "e":
        name = f"copy_{target}"
        np.testing.assert_array_equal(
            getattr(tops, name)(tg, torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jops, name)(jg, jnp.asarray(x))))


def test_sddmm_namespace():
    """The port's ``ops`` exports the reference's names; the generated
    ``copy_u`` is g-SDDMM's, as in the reference."""
    names = [n for n in jops.__all__ if not n.startswith("_")]
    assert sorted(set(names) - set(dir(tops))) == []
    assert tops.copy_u.__module__.endswith("sddmm")
    assert tops.copy_u_sum.__module__.endswith("spmm")


# ---------------------------------------------------------------------------
# edge_softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["simple", "padded", "multi"])
@pytest.mark.parametrize("norm_by", ["dst", "src"])
@pytest.mark.parametrize("feat", [(3,), (2, 1)])
def test_edge_softmax(kind, norm_by, feat):
    """On the padded graph the real edges are compared (values and the
    gradient of the real logits); the reference's values on padded edges
    are meaningless (clamped gathers, often inf), the port's are 0."""
    jg, tg = _graph(kind, seed=3)
    x = _operand(tg, "e", feat, 14) * 3
    E = tg.num_edges()
    pad = x[E:]
    _check(lambda a: jops.edge_softmax(
               jg, jnp.concatenate([a, pad]), norm_by=norm_by)[:E],
           lambda a: tops.edge_softmax(
               tg, torch.cat([a, torch.from_numpy(pad)]),
               norm_by=norm_by)[:E], [x[:E]])
    out = tops.edge_softmax(tg, torch.from_numpy(x), norm_by=norm_by)
    assert out.shape == x.shape and not out[E:].any()


@pytest.mark.parametrize("norm_by", ["dst", "src"])
def test_edge_softmax_eids(norm_by):
    """A subset of the edges: the others get 0 and no gradient."""
    jg, tg = _graph("simple", seed=4)
    x = _operand(tg, "e", (2,), 15)
    eids = np.sort(np.random.default_rng(6).choice(
        tg.num_edges(), tg.num_edges() // 3, replace=False))
    _check(lambda a: jops.edge_softmax(jg, a, eids=eids, norm_by=norm_by),
           lambda a: tops.edge_softmax(tg, a, eids=torch.from_numpy(eids),
                                       norm_by=norm_by), [x])
    out = tops.edge_softmax(tg, torch.from_numpy(x), eids=eids,
                            norm_by=norm_by).numpy()
    rest = np.setdiff1d(np.arange(tg.num_edges()), eids)
    assert not out[rest].any()


def test_edge_softmax_unported_branches_raise():
    jg, tg = _graph("simple", seed=5)
    rel = tg._relation()
    x = torch.zeros(tg.num_edges(), 2)
    # the uniform-stride branch runs since the minibatch slice: on a
    # relation of 4 in-edges a destination, in stripes, the reference's
    # values, forward and gradient
    n = 30
    src = np.random.default_rng(7).integers(0, n, 4 * n)
    dst = np.repeat(np.arange(n), 4)
    jrel = dgl_tpu.graph((src, dst), num_nodes=n)._relation(None)
    jrel.uniform_stride = 4
    trel = dt.graph((src, dst), num_nodes=n, device="cpu")._relation()
    _check(lambda a: jops.edge_softmax(jrel, a),
           lambda a: tops.edge_softmax(trel._copy_with(uniform_stride=4), a),
           [np.random.default_rng(8).normal(size=(4 * n, 2)).astype(
               np.float32)])
    # the shell-plan branch runs since the weighted g-SpMM slice: the
    # reference's values over its weighted plan, forward and gradient
    kw = dict(num_hubs=16, weighted=True, gather_dtype="f32")
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    assert tgp._relation().shell_plan is not None
    _check(lambda a: jops.edge_softmax(jgp, a),
           lambda a: tops.edge_softmax(tgp, a),
           [_rand(tuple(x.shape), 9)])
    with pytest.raises(ValueError, match="norm_by"):
        tops.edge_softmax(rel, x, norm_by="both")


# ---------------------------------------------------------------------------
# g-SpMM max / min
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce_op", ["max", "min"])
@pytest.mark.parametrize("op", ["copy_lhs", "copy_rhs", "add", "sub", "mul",
                                "div"])
def test_gspmm_cmp(op, reduce_op):
    """The last 10 nodes have no in-edge: their rows are 0 on both
    sides."""
    jg, tg = _graph("simple", seed=6)
    u = _rand((N, 3, 2), 16)
    e = _rand((tg.num_edges(), 3, 1), 17, positive=op == "div")
    if op == "copy_lhs":
        args, jf = [u], lambda a: jops.gspmm(jg, op, reduce_op, a, None)
        tf = lambda a: tops.gspmm(tg, op, reduce_op, a, None)  # noqa: E731
    elif op == "copy_rhs":
        args, jf = [e], lambda b: jops.gspmm(jg, op, reduce_op, None, b)
        tf = lambda b: tops.gspmm(tg, op, reduce_op, None, b)  # noqa: E731
    else:
        args, jf = [u, e], lambda a, b: jops.gspmm(jg, op, reduce_op, a, b)
        tf = lambda a, b: tops.gspmm(tg, op, reduce_op, a, b)  # noqa: E731
    _check(jf, tf, args)
    out = tf(*[torch.from_numpy(a) for a in args])
    assert not out[-10:].any()
    assert (tg.in_degrees()[-10:] == 0).all()


def test_gspmm_cmp_padded_and_named():
    jg, tg = _graph("padded", seed=7)
    u = _rand((N, 4), 18)
    e = _rand((tg._relation().src.shape[0], 4), 19)
    for name in ("copy_u_max", "copy_u_min"):
        np.testing.assert_allclose(
            getattr(tops, name)(tg, torch.from_numpy(u)).numpy(),
            np.asarray(getattr(jops, name)(jg, jnp.asarray(u))), **TOL)
    for name in ("u_add_e_max", "u_mul_e_min", "copy_e_max"):
        args = (u, e) if name.startswith("u_") else (e,)
        np.testing.assert_allclose(
            getattr(tops, name)(tg, *map(torch.from_numpy, args)).numpy(),
            np.asarray(getattr(jops, name)(jg, *map(jnp.asarray, args))),
            **TOL)


# ---------------------------------------------------------------------------
# core: the builtin lowering, UDFs, apply_edges / apply_nodes
# ---------------------------------------------------------------------------

MESSAGES = [("u_add_v", "sum"), ("u_dot_v", "max"), ("v_sub_e", "mean"),
            ("e_sub_u", "sum"), ("e_div_u", "min"), ("u_dot_e", "sum"),
            ("e_mul_u", "max"), ("copy_e", "min"), ("v_mul_u", "sum"),
            ("u_mul_e", "mean")]


def _update_all(g, fn_mod, msg, red, u, v, e):
    """Set the frames, run one builtin ``update_all`` and return the new
    node field (the frames restored after)."""
    with g.local_scope():
        g.ndata["u"], g.ndata["v"], g.edata["e"] = u, v, e
        if msg == "copy_e":
            mfunc = fn_mod.copy_e("e", "m")
        else:
            lt, op, rt = msg.split("_")
            mfunc = getattr(fn_mod, msg)(lt, rt, "m")
        g.update_all(mfunc, getattr(fn_mod, red)("m", "o"))
        return g.ndata["o"]


@pytest.mark.parametrize("msg,red", MESSAGES, ids=[m + "-" + r
                                                   for m, r in MESSAGES])
def test_update_all_lowering(msg, red):
    """Builtin messages that read ``v``, ``dot`` and ``e sub/div u`` are
    materialised with g-SDDMM and reduced as ``copy_e``; the others are
    one g-SpMM. Every frame holds (.., 3, 4) values; ``u`` is positive for
    ``e_div_u``."""
    jg, tg = _graph("simple", seed=8)
    u = _rand((N, 3, 4), 20, positive=True)
    v = _rand((N, 3, 4), 21)
    e = _rand((tg.num_edges(), 3, 4), 22)
    _check(lambda u, v, e: _update_all(jg, jfn, msg, red, u, v, e),
           lambda u, v, e: _update_all(tg, tfn, msg, red, u, v, e),
           [u, v, e])


def _udf_pass(g, h, w, amax=None):
    """An edge UDF message, a mailbox reducer (a sum, or with ``amax`` a
    maximum over the real slots, 0 for a node without in-edges) and an
    apply-node function."""
    def message(edges):
        return {"m": edges.src["h"] * edges.data["w"] + edges.dst["h"]}

    def reduce(nodes):
        mb = nodes.mailbox["m"]
        if amax is None:
            return {"o": mb.sum(1)}
        mask = nodes.mailbox_mask[:, :, None] * 1.0
        return {"o": amax(mb * mask - 1e9 * (1.0 - mask)) * amax(mask)}

    def apply(nodes):
        return {"o": nodes.data["o"] * 2 + nodes.data["h"]}

    with g.local_scope():
        g.ndata["h"], g.edata["w"] = h, w
        g.update_all(message, reduce, apply)
        return g.ndata["o"]


@pytest.mark.parametrize("masked_max", [False, True])
def test_udf_reduce(masked_max):
    jg, tg = _graph("simple", seed=9)
    h = _rand((N, 3), 23)
    w = _rand((tg.num_edges(), 1), 24)
    jmax = (lambda x: x.max(axis=1)) if masked_max else None
    tmax = (lambda x: x.amax(1)) if masked_max else None
    _check(lambda h, w: _udf_pass(jg, h, w, jmax),
           lambda h, w: _udf_pass(tg, h, w, tmax), [h, w])


def test_builtin_message_udf_reduce_and_udf_message_builtin_reduce():
    jg, tg = _graph("simple", seed=10)
    h = _rand((N, 2), 25)

    def run(g, h, fn_mod, which):
        with g.local_scope():
            g.ndata["h"] = h
            if which == 0:
                g.update_all(fn_mod.copy_u("h", "m"),
                             lambda nodes: {"o": nodes.mailbox["m"].sum(1)})
            else:
                g.update_all(lambda edges: {"m": edges.src["h"] * 3},
                             fn_mod.max("m", "o"))
            return g.ndata["o"]

    for which in (0, 1):
        _check(lambda h: run(jg, h, jfn, which),
               lambda h: run(tg, h, tfn, which), [h])


def test_apply_edges_and_nodes_subsets():
    """Builtin and UDF ``apply_edges`` over all edges and over a subset
    (only the subset's rows are written, zeros elsewhere for a new
    field), ``apply_nodes`` likewise."""
    jg, tg = _graph("simple", seed=11)
    h = _rand((N, 3), 26)
    for g, fn_mod, cast in ((jg, jfn, jnp.asarray), (tg, tfn,
                                                     torch.from_numpy)):
        g.ndata["h"] = cast(h)
        g.apply_edges(fn_mod.u_sub_v("h", "h", "d"))
        g.apply_edges(lambda edges: {"s": edges.src["h"] * edges.dst["h"]},
                      edges=[3, 7, 11])
        g.apply_edges(lambda edges: {"d": edges.data["d"] + 100.0},
                      edges=np.array([0, 5]))
        g.apply_nodes(lambda nodes: {"h2": nodes.data["h"] ** 2}, v=[1, 2])
        g.apply_nodes(lambda nodes: {"h": nodes.data["h"] + 1})
    for field in ("d", "s"):
        np.testing.assert_allclose(tg.edata[field].numpy(),
                                   np.asarray(jg.edata[field]), **TOL)
    for field in ("h", "h2"):
        np.testing.assert_allclose(tg.ndata[field].numpy(),
                                   np.asarray(jg.ndata[field]), **TOL)
    assert not tg.edata["s"].numpy()[[0, 1, 2, 4]].any()
    sub = tg.apply_edges(tfn.u_add_v("h", "h", "q"), edges=[4])
    assert sub["q"].shape == (1, 3)


def test_later_paths_raise():
    """``pull``, ``push``, ``send_and_recv`` and ``multi_update_all`` run
    since the heterogeneous slice (they raised before it): the reference's
    frames on the same graph, field by field."""
    jg, tg = _graph("simple", seed=12)
    h = _rand((N, 2), 5)
    jg.ndata["h"] = jnp.asarray(h)
    tg.ndata["h"] = torch.from_numpy(h)
    for g, fn in ((jg, jfn), (tg, tfn)):
        msg, red = fn.copy_u("h", "m"), fn.sum("m", "o")
        g.pull([0, 1], msg, red)
        g.push([0], msg, fn.max("m", "p"))
        g.send_and_recv([0, 1], msg, fn.mean("m", "s"))
        g.multi_update_all({None: (msg, red)}, "sum")
    for field in ("o", "p", "s"):
        np.testing.assert_allclose(tg.ndata[field].numpy(),
                                   np.asarray(jg.ndata[field]), **TOL)


def test_relation_reverse_and_edge_mask():
    jg, tg = _graph("padded", seed=13)
    jr, tr = jg._relation(None).reverse(), tg._relation().reverse()
    for f in dt.Relation.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    for f in ("num_src", "num_dst", "num_edges", "max_in_degree",
              "max_out_degree"):
        assert getattr(tr, f) == getattr(jr, f), f
    np.testing.assert_array_equal(tg._relation().edge_mask().numpy(),
                                  np.asarray(jg._relation(None).edge_mask()))
