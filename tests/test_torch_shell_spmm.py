"""The port's weighted shell plan and shell g-SpMM against ``dgl_tpu``.

Graphs: a power-law graph whose in- and out-degrees pass ``SHELL_CAP`` = 32,
so both directions have a residual, and a uniform random graph relabelled
by in-degree rank, whose destination rank order is the identity (no
unrank) and whose degrees stay under the cap (no residual; fewer levels,
so the reference compiles faster). Inputs are made once with numpy and go
to both sides.

The reference runs under ``jax.jit`` (its eager shell sums take seconds a
call), compiled with ``xla_allow_excess_precision`` off: XLA's CPU otherwise
keeps f32 where a program rounds a bf16 result back to f32, so it would
skip the bf16 rounding of the messages that the reference writes (and that
its TPU path, which hands the messages to its Pallas kernel as a bf16
array, performs).

Tolerances:

- plan arrays and kernel layouts: exact (the same stable sorts);
- ``shell_prefix_gspmm_plain`` against ``shell_prefix_sum_pallas`` in
  interpret mode, fed the reference's own message stream and residual
  base: exact (the same f32 adds of the same rounded messages in the same
  order); the two residual bases: rtol = 1e-6 (XLA's reduce sums each
  32-row block in another order);
- f32 plans: rtol = 1e-5, atol = 1e-5 * max|ref| (the same f32 terms; the
  residual's block partials are summed in another order);
- bf16 plans: the same, except that at most 1 element in 1000 may differ
  by one bf16 step (2**-8 * max|ref|): the same rounded messages, whose
  f32 sums differ in the last bit where the order differs, can round to
  neighbouring bf16 values in a later rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.shell_pallas as sp
import dgl_tpu.ops.shell_spmm as jss
from dgl_tpu import ops as jops
from dgl_tpu.nn import EdgeWeightNorm as JEdgeWeightNorm
from dgl_tpu.nn import GraphConv as JGraphConv
import dgl_tpu_torch as dt
from dgl_tpu_torch import ops as tops
from dgl_tpu_torch.nn import EdgeWeightNorm, GraphConv
from dgl_tpu_torch.ops import shell_spmm as tss
from dgl_tpu_torch.ops.shell_prefix import (
    level_table, shell_prefix_gspmm, shell_prefix_gspmm_plain)

N, E = 300, 4000  # the power-law graph; the ranked one has 1,500 edges
OPS = ["add", "sub", "mul", "div", "copy_lhs", "copy_rhs"]


def _edges(kind, seed=0):
    """``powerlaw``: zipf sources and (reversed) zipf destinations, node 0
    sends and node N-1 receives far more than 32 edges. ``ranked``: 1,500
    uniform edges, the nodes relabelled in stable order of falling
    in-degree. ``tiles``: chip_smoke.py's edge-case graph of 3,001 nodes
    whose levels end at the weighted kernel's tile edges (32 levels, a
    residual, rows without an in-edge, unrank not the identity)."""
    rng = np.random.default_rng(seed)
    if kind == "tiles":
        from chip_smoke import tiles_edges

        return tiles_edges(rng)[:2]
    if kind == "powerlaw":
        w = 1.0 / np.arange(1, N + 1)
        return (rng.choice(N, E, p=w / w.sum()),
                rng.choice(N, E, p=w[::-1] / w.sum()))
    src, dst = rng.integers(0, N, 1500), rng.integers(0, N, 1500)
    perm = np.argsort(-np.bincount(dst, minlength=N), kind="stable")
    new = np.empty(N, np.int64)
    new[perm] = np.arange(N)
    return new[src], new[dst]


_GRAPHS = {}


def _n(kind):
    """The graph's node count."""
    return 3001 if kind == "tiles" else N


def _graphs(kind):
    if kind not in _GRAPHS:
        src, dst = _edges(kind)
        n = _n(kind)
        _GRAPHS[kind] = (dgl_tpu.graph((src, dst), num_nodes=n),
                         dt.graph((src, dst), num_nodes=n, device="cpu"))
    return _GRAPHS[kind]


_PLANS = {}


def _plans(kind, gd):
    if (kind, gd) not in _PLANS:
        jg, tg = _graphs(kind)
        _PLANS[kind, gd] = (jss.build_shell_plan(jg._relation(None), gd),
                            tss.build_shell_plan(tg._relation(), gd))
    return _PLANS[kind, gd]


def _exact(fn, *args):
    """``fn(*args)`` compiled by XLA with excess precision off."""
    args = [jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _ref_vjp(fn, args, cot):
    """The reference's output and the gradients of ``sum(fn(*args) *
    cot)``."""
    def both(*a):
        out, pull = jax.vjp(fn, *a)
        return out, pull(jnp.asarray(cot))

    out, grads = _exact(both, *args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_vjp(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(out, ref, gd, what="", tol=1e-5):
    """The file's tolerance for an f32 or a bf16 plan (``tol`` in place of
    1e-5 where a caller states another)."""
    assert out.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    if gd == "f32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * scale,
                                   err_msg=what)
        return
    bad = np.abs(out - ref) > tol * scale + tol * np.abs(ref)
    assert bad.mean() <= 1e-3, f"{what}: {bad.sum()} of {bad.size}"
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0 ** -8 * scale,
                               err_msg=what)


def _operands(op, u_shape, e_shape, seed):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=u_shape).astype(np.float32)
    if op == "div":  # away from 0
        e = (rng.random(e_shape) + 0.5).astype(np.float32)
    else:
        e = rng.normal(size=e_shape).astype(np.float32)
    return ([] if op == "copy_rhs" else [u]) + (
        [] if op == "copy_lhs" else [e])


def _split(op, a):
    it = iter(a)
    u = None if op == "copy_rhs" else next(it)
    e = None if op == "copy_lhs" else next(it)
    return u, e


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _assert_same(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, name
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{name}[{i}]")
        return
    np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a),
                                  err_msg=name)


def _assert_plans_equal(jp, tp):
    for f in jss.ShellSpMMPlan.ARRAY_FIELDS:
        _assert_same(getattr(jp, f), getattr(tp, f), f)
    assert (tp.num_src, tp.num_dst, tp.gather_dtype) == (
        jp.num_src, jp.num_dst, jp.gather_dtype)


@pytest.mark.parametrize("gd", ["bf16", "f32"])
@pytest.mark.parametrize("kind", ["powerlaw", "ranked", "tiles"])
def test_plan_arrays_equal(kind, gd):
    """Every array of the reference's plan, and the kernel's layouts: the
    reference's flat index vectors (``flat_shell_indices`` with index 0 in
    padded slots) and each level's real row count (its mask's ones)."""
    jp, tp = _plans(kind, gd)
    _assert_plans_equal(jp, tp)
    assert (tp.res_dst is not None) == (kind != "ranked")
    assert (tp.res_src is not None) == (kind == "powerlaw")
    assert (tp.unrank_dst is None) == (kind == "ranked")
    if kind == "tiles":
        from chip_smoke import TILE_LEVEL_ENDS

        assert tp.fwd.level_real == list(TILE_LEVEL_ENDS)
    for shells, lay in ((jp.shells, tp.fwd), (jp.rev_shells, tp.rev)):
        for i in (0, 1):
            flat, rows = sp.flat_shell_indices([s[i] for s in shells],
                                               _n(kind), oob_index=0)
            assert rows == lay.level_rows
            np.testing.assert_array_equal(
                (lay.nidx, lay.eidx)[i].numpy(), np.asarray(flat))
        assert lay.level_real == [int(np.asarray(s[2]).sum())
                                  for s in shells]
        np.testing.assert_array_equal(lay.levels[1].numpy(), lay.level_real)


@pytest.mark.parametrize("gd", ["bf16", "f32"])
def test_with_spmm_plans_and_reorder_weighted(gd):
    """``with_spmm_plans(weighted=True)`` and ``reorder_for_spmm(...,
    weighted=True)`` attach the reference's shell plan beside the hub plan;
    ``.to`` carries it and ``reverse()`` drops every plan."""
    jg, tg = _graphs("powerlaw")
    kw = dict(num_hubs=16, weighted=True, gather_dtype=gd)
    jrel = jg.with_spmm_plans(**kw)._relation(None)
    trel = tg.with_spmm_plans(**kw)._relation()
    assert trel.hub_plan is not None
    _assert_plans_equal(jrel.shell_plan, trel.shell_plan)
    moved = trel.to("cpu")
    _assert_plans_equal(jrel.shell_plan, moved.shell_plan)
    assert moved.shell_plan.fwd.level_real == trel.shell_plan.fwd.level_real
    rev = trel.reverse()
    assert rev.shell_plan is None and rev.hub_plan is None
    assert rev.dense_adj is None and rev.bitmap_plan is None
    j2, jperm = dgl_tpu.transforms.reorder_for_spmm(jg, num_hubs=16, **{
        k: v for k, v in kw.items() if k != "num_hubs"})
    t2, tperm = dt.transforms.reorder_for_spmm(tg, num_hubs=16, **{
        k: v for k, v in kw.items() if k != "num_hubs"})
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    _assert_plans_equal(j2._relation(None).shell_plan,
                        t2._relation().shell_plan)
    # an already rank-ordered graph keeps its ids, plans attached
    jg3, tg3 = _graphs("ranked")
    j3, jp3 = dgl_tpu.transforms.reorder_for_spmm(jg3, num_hubs=16,
                                                  weighted=True,
                                                  gather_dtype=gd)
    t3, tp3 = dt.transforms.reorder_for_spmm(tg3, num_hubs=16, weighted=True,
                                             gather_dtype=gd)
    np.testing.assert_array_equal(tp3, np.asarray(jp3))
    _assert_plans_equal(j3._relation(None).shell_plan,
                        t3._relation().shell_plan)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gd", ["bf16", "f32"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["powerlaw", "tiles"])
def test_plain_matches_pallas_interpret(kind, op, gd):
    """The reference's weighted caller: one flat masked message stream
    (``msg_of`` over the flat indices, padded slots selected to 0) into
    ``shell_prefix_sum_pallas`` in interpret mode, with the residual as its
    base; the port's plain version over its own layout and base."""
    jp, tp = _plans(kind, gd)
    N, E = tp.num_dst, int(tp.emask.shape[0])
    u_shape, e_shape = (N, 2, 64), ((E, 2, 64) if op == "copy_rhs"
                                    else (E, 2, 1))
    u, e = _split(op, _operands(op, u_shape, e_shape, 1))
    cast = jnp.bfloat16 if gd == "bf16" else jnp.float32
    ub = None if u is None else jnp.asarray(u).astype(cast)
    eb = None if e is None else jnp.asarray(e).astype(cast)

    nidx_f, rows = sp.flat_shell_indices([s[0] for s in jp.shells], N,
                                         oob_index=0)
    eidx_f, _ = sp.flat_shell_indices([s[1] for s in jp.shells], N,
                                      oob_index=0)
    mask_f, _ = sp.flat_shell_indices(
        [s[2][:, 0].astype(jnp.int32) for s in jp.shells], N, oob_index=0)

    def stream(ub, eb):
        msg = jss._msg(op, None if ub is None else ub[nidx_f],
                       None if eb is None else eb[eidx_f])
        msg = jnp.where((mask_f > 0)[:, None, None], msg,
                        jnp.zeros((), msg.dtype))
        r_nidx, r_eidx, _p, _b, r_mask = jp.res_dst
        rmsg = jss._msg(op, None if ub is None else ub[r_nidx],
                        None if eb is None else eb[r_eidx])
        rmsg = jnp.where(r_mask[:, :, None] > 0, rmsg.astype(jnp.float32),
                         0.0)
        base = jss.residual_reduce(rmsg, jp.res_dst, jss._rup(N, 8), "sum")
        return msg.reshape(msg.shape[0], -1), base

    # the stream materialised, as the kernel's input is on the TPU
    msg, ref_base = _exact(lambda *a: stream(*_split(op, a)),
                           *[x for x in (ub, eb) if x is not None])
    sp._FORCE_PALLAS_INTERPRET = True
    try:
        ref = _exact(lambda m, b: sp.shell_prefix_sum_pallas(
            m, rows, N, base=b.reshape(b.shape[0], -1))[:N], msg, ref_base)
    finally:
        sp._FORCE_PALLAS_INTERPRET = False
    to_t = lambda x: None if x is None else torch.from_numpy(  # noqa: E731
        np.array(x.astype(jnp.float32))).to(
            torch.bfloat16 if gd == "bf16" else torch.float32)
    ut, et = to_t(ub), to_t(eb)
    # the residual's block sums: the same f32 terms, summed over each block
    # in another order than XLA's reduce
    ref_base = np.array(ref_base)
    base = tss._residual_base(op, ut, et, tp.res_dst, N)
    np.testing.assert_allclose(base.numpy().reshape(ref_base.shape),
                               ref_base, rtol=1e-6,
                               atol=1e-6 * np.abs(ref_base).max())
    base = torch.from_numpy(ref_base).reshape(base.shape)
    lay = tp.fwd
    out = shell_prefix_gspmm_plain(op, ut, et, lay.nidx, lay.eidx,
                                   lay.level_rows, lay.level_real, N,
                                   base=base)
    np.testing.assert_array_equal(out.numpy().reshape(N, -1),
                                  np.asarray(ref))
    # the wrapper takes the plain version on CPU tensors
    torch.testing.assert_close(
        shell_prefix_gspmm(op, ut, et, lay.nidx, lay.eidx, lay.level_rows,
                           lay.level_real, N, base=base), out, rtol=0,
        atol=0)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["powerlaw", "tiles"])
def test_plain_rank_is_the_unrank_gather(kind, op):
    """``rank=plan.rank_dst`` stores each rank row at its node: bit for bit
    the rank-order result gathered by ``unrank`` (the gather it replaces),
    with the residual's base, bf16 tables; the wrapper too."""
    _, tp = _plans(kind, "bf16")
    n, n_e = tp.num_dst, int(tp.emask.shape[0])
    u, e = _split(op, _operands(op, (n, 2, 8), (n_e, 2, 8) if op ==
                                "copy_rhs" else (n_e, 2, 1), 3))
    ut, et = (None if x is None else torch.from_numpy(x).to(torch.bfloat16)
              for x in (u, e))
    lay = tp.fwd
    base = tss._residual_base(op, ut, et, tp.res_dst, n)
    args = (op, ut, et, lay.nidx, lay.eidx, lay.level_rows, lay.level_real,
            n)
    ranked = shell_prefix_gspmm_plain(*args, base=base)
    by_node = shell_prefix_gspmm_plain(*args, base=base, rank=tp.rank_dst)
    assert torch.equal(by_node,
                       ranked.index_select(0, tp.unrank_dst.long()))
    assert torch.equal(shell_prefix_gspmm(*args, base=base,
                                          rank=tp.rank_dst), by_node)


def test_wrapper_checks_its_arguments():
    _, tp = _plans("powerlaw", "f32")
    lay = tp.fwd
    u = torch.zeros(N, 4)
    with pytest.raises(ValueError, match="lhs and rhs"):
        shell_prefix_gspmm("mul", u, None, lay.nidx, lay.eidx,
                           lay.level_rows, lay.level_real, N)
    with pytest.raises(ValueError, match="unknown op"):
        shell_prefix_gspmm("pow", u, u, lay.nidx, lay.eidx,
                           lay.level_rows, lay.level_real, N)
    with pytest.raises(ValueError, match="level_real"):
        shell_prefix_gspmm("copy_lhs", u, None, lay.nidx, lay.eidx,
                           lay.level_rows, lay.level_rows[:-1], N)
    with pytest.raises(ValueError, match="shorter"):
        shell_prefix_gspmm("copy_lhs", u, None, lay.nidx[:100], lay.eidx,
                           lay.level_rows, lay.level_real, N)
    # at most SHELL_CAP levels, their real counts non-increasing
    flat = torch.zeros(33 * 512, dtype=torch.int32)
    with pytest.raises(ValueError, match="SHELL_CAP"):
        shell_prefix_gspmm("copy_lhs", u, None, flat, flat, [512] * 33,
                           [1] * 33, N)
    real = list(lay.level_real)
    real[0] = real[1] - 1
    with pytest.raises(ValueError, match="not increase"):
        shell_prefix_gspmm("copy_lhs", u, None, lay.nidx, lay.eidx,
                           lay.level_rows, real, N)
    # rank: an int32 permutation of the n_out rows, on the tables' device
    rank = tp.rank_dst.clone()
    for bad, match in ((rank.long(), "int32"), (rank[:-1], "n_out"),
                       (torch.zeros_like(rank), "permutation")):
        with pytest.raises(ValueError, match=match):
            shell_prefix_gspmm("copy_lhs", u, None, lay.nidx, lay.eidx,
                               lay.level_rows, lay.level_real, N, rank=bad)
    shell_prefix_gspmm("copy_lhs", u, None, lay.nidx, lay.eidx,
                       lay.level_rows, lay.level_real, N, rank=rank)
    rank[0] = rank[1]  # changed in place after a check: checked again
    with pytest.raises(ValueError, match="permutation"):
        shell_prefix_gspmm("copy_lhs", u, None, lay.nidx, lay.eidx,
                           lay.level_rows, lay.level_real, N, rank=rank)
    # no level and no base: zeros of the message's shape
    empty = torch.zeros(0, dtype=torch.int32)
    out = shell_prefix_gspmm("mul", torch.ones(N, 2, 3), torch.ones(5, 2, 1),
                             empty, empty, [], [], N)
    assert out.shape == (N, 2, 3) and not out.any()
    assert tuple(level_table([], "cpu", counts=[]).shape) == (2, 0)


# ---------------------------------------------------------------------------
# shell_gspmm_sum, forward and gradients
# ---------------------------------------------------------------------------


def _check_sum(kind, gd, op, u_feat, e_feat, seed):
    """``gspmm`` with the sum and the mean reducer over a relation that
    carries the shell plan alone (so ``copy_u`` takes it too), stacked:
    the forward and every operand's gradient, on both sides."""
    jp, tp = _plans(kind, gd)
    jg, tg = _graphs(kind)
    jrel = jg._relation(None).with_shell_plan(jp)
    trel = tg._relation().with_shell_plan(tp)
    n_edges = tg.num_edges()
    args = _operands(op, (N,) + u_feat, (n_edges,) + e_feat, seed)

    def both(ops, rel, stack):
        return lambda *a: stack([ops.gspmm(rel, op, r, *_split(op, a))
                                 for r in ("sum", "mean")])

    shape = both(tops, trel, torch.stack)(
        *[torch.from_numpy(a) for a in args]).shape
    cot = np.random.default_rng(seed + 1).normal(size=shape).astype(
        np.float32)
    ref, jgrads = _ref_vjp(both(jops, jrel, jnp.stack), args, cot)
    out, tgrads = _port_vjp(both(tops, trel, torch.stack), args, cot)
    _close(out, ref, gd, f"{op} out")
    for i, (a, b) in enumerate(zip(tgrads, jgrads)):
        _close(a, b, gd, f"{op} grad {i}")


@pytest.mark.parametrize("gd", ["bf16", "f32"])
@pytest.mark.parametrize("op", OPS)
def test_shell_gspmm_sum(op, gd):
    """Every op with sum and mean: forward, ``du`` (the reverse shells
    through the kernel's plain version, the cotangent rounded to the
    gather dtype) and ``de`` (gathers of the f32 cotangent and tables),
    with both residuals."""
    e_feat = (2, 4) if op == "copy_rhs" else (2, 1)
    _check_sum("powerlaw", gd, op, (2, 4), e_feat, OPS.index(op))


@pytest.mark.parametrize("shapes", [
    ("mul", (16,), (1,)),
    ("add", (2, 4), (2, 4)),
    ("div", (2, 4), (1, 1)),
    ("copy_rhs", (1,), ()),
])
def test_shell_gspmm_sum_broadcasts(shapes):
    """The broadcasts ``gspmm`` hands the shell path (feature shapes of the
    node and edge tables), on the graph whose destination rank order is
    the identity; ``copy_rhs`` of a 1-D edge value is ``EdgeWeightNorm``'s
    degree sum."""
    op, u_feat, e_feat = shapes
    _check_sum("ranked", "bf16", op, u_feat, e_feat, 7)


@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
def test_gspmm_dispatches_to_the_shell_plan(reduce_op):
    """``ops.gspmm`` on a graph with both plans: ``u_mul_e`` takes the
    shell plan, ``copy_u`` still the hub plan (the reference's order), with
    the reference's values."""
    jg, tg = _graphs("ranked")
    kw = dict(num_hubs=16, weighted=True, gather_dtype="f32")
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    args = _operands("mul", (N, 2, 4), (tg.num_edges(), 2, 1), 11)
    cot = np.random.default_rng(12).normal(size=(N, 2, 4)).astype(
        np.float32)
    ref, jgrads = _ref_vjp(
        lambda u, e: jops.gspmm(jgp, "mul", reduce_op, u, e), args, cot)
    out, tgrads = _port_vjp(
        lambda u, e: tops.gspmm(tgp, "mul", reduce_op, u, e), args, cot)
    _close(out, ref, "f32", "out")
    for a, b in zip(tgrads, jgrads):
        _close(a, b, "f32", "grad")
    calls = []
    orig = tss.shell_gspmm_sum
    tss.shell_gspmm_sum = lambda *a: calls.append(a[0]) or orig(*a)
    try:
        tops.gspmm(tgp, "copy_lhs", reduce_op, torch.from_numpy(args[0]),
                   None)
        tops.gspmm(tgp, "mul", reduce_op, *map(torch.from_numpy, args))
    finally:
        tss.shell_gspmm_sum = orig
    assert calls == ["mul"]


# ---------------------------------------------------------------------------
# max / min, edge softmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,reduce_op", [
    ("add", "max"), ("mul", "min"), ("copy_lhs", "min"), ("copy_rhs", "max")])
def test_gspmm_cmp(op, reduce_op):
    """Tie-free inputs (distinct random values): both sides route each
    gradient to the one extremal message."""
    jg, tg = _graphs("ranked")
    kw = dict(num_hubs=16, weighted=True, gather_dtype="f32")
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    n_e = tg.num_edges()
    args = _operands(op, (N, 3), (n_e, 3) if op == "copy_rhs" else (n_e, 1),
                     21)
    cot = np.random.default_rng(22).normal(size=(N, 3)).astype(np.float32)
    ref, jgrads = _ref_vjp(
        lambda *a: jops.gspmm(jgp, op, reduce_op, *_split(op, a)), args, cot)
    out, tgrads = _port_vjp(
        lambda *a: tops.gspmm(tgp, op, reduce_op, *_split(op, a)), args, cot)
    _close(out, ref, "f32", "out")
    for a, b in zip(tgrads, jgrads):
        _close(a, b, "f32", "grad")


@pytest.mark.parametrize("norm_by", ["dst", "src"])
@pytest.mark.parametrize("kind", ["powerlaw", "ranked"])
def test_edge_softmax(kind, norm_by):
    """The shell edge softmax (max and exp-sum over the rank-space
    prefixes, residual included) and its backward."""
    jg, tg = _graphs(kind)
    kw = dict(num_hubs=16, weighted=True, gather_dtype="bf16")
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    assert tgp._relation().shell_plan is not None
    n_e = tg.num_edges()
    x = np.random.default_rng(31).normal(size=(n_e, 2)).astype(
        np.float32) * 3
    cot = np.random.default_rng(32).normal(size=(n_e, 2)).astype(np.float32)
    ref, jgrads = _ref_vjp(
        lambda a: jops.edge_softmax(jgp, a, norm_by=norm_by), [x], cot)
    out, tgrads = _port_vjp(
        lambda a: tops.edge_softmax(tgp, a, norm_by=norm_by), [x], cot)
    _close(out, ref, "f32", "out")
    _close(tgrads[0], jgrads[0], "f32", "grad")


# ---------------------------------------------------------------------------
# EdgeWeightNorm + GraphConv with edge weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gd", ["bf16", "f32"])
def test_edge_weight_norm_graphconv(gd):
    """DGL's weighted GCN layer: ``EdgeWeightNorm("both")`` (its
    destination degrees over the shell plan, its source degrees over the
    plain reverse relation) feeding ``GraphConv(norm="none")``'s
    ``u_mul_e`` sum over the shell plan; the reference's weights carried
    across with ``from_flax_params``. Forward and the gradients of the
    features and the raw edge weights."""
    jg, tg = _graphs("ranked")
    kw = dict(num_hubs=16, weighted=True, gather_dtype=gd)
    jgp, tgp = jg.with_spmm_plans(**kw), tg.with_spmm_plans(**kw)
    rng = np.random.default_rng(41)
    x = rng.normal(size=(N, 8)).astype(np.float32)
    w = (rng.random(tg.num_edges()) + 0.5).astype(np.float32)
    jconv = JGraphConv(8, 16, norm="none", allow_zero_in_degree=True)
    # initialised on the graph without plans: the same parameters, without
    # an eager pass over the shells
    params = jconv.init(jax.random.PRNGKey(0), jg, jnp.asarray(x),
                        edge_weight=jnp.asarray(w))
    conv = GraphConv(8, 16, norm="none", allow_zero_in_degree=True,
                     device="cpu")
    conv.load_state_dict(dt.from_flax_params(params))
    cot = rng.normal(size=(N, 16)).astype(np.float32)

    def jf(x, w):
        nw = JEdgeWeightNorm("both").apply({}, jgp, w)
        return jconv.apply(params, jgp, x, edge_weight=nw)

    ref, jgrads = _ref_vjp(jf, [x, w], cot)
    out, tgrads = _port_vjp(
        lambda x, w: conv(tgp, x, edge_weight=EdgeWeightNorm("both")(tgp, w)),
        [x, w], cot)
    _close(out, ref, gd, "out")
    for a, b in zip(tgrads, jgrads):
        _close(a, b, gd, "grad")
    np.testing.assert_allclose(
        EdgeWeightNorm("right")(tgp, torch.from_numpy(w)).numpy(),
        np.asarray(_exact(lambda w: JEdgeWeightNorm("right").apply(
            {}, jgp, w), w)), rtol=1e-5, atol=1e-6)
