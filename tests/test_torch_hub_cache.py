"""The port's hub-cache g-SpMM (``ops.hub_cache``, kernel B6's module)
against ``dgl_tpu.ops.pallas_hub``, whose Pallas kernel runs in interpret
mode here.

Tolerances:

- ``HubPlan`` arrays: exact (the same stable argsort over the same degrees).
- ``hub_gather``: exact. Both are selections of one table row (or of zero);
  the reference's one-hot product adds one nonzero term, and with
  ``precision="bf16"`` both round the value to bf16 before widening it.
- ``hub_copy_u_sum`` against the reference's: rtol = atol = 1e-5, the same
  f32 rows summed in another order (``index_add`` against
  ``segment_sum``).
- ``hub_copy_u_sum`` against the exact ``copy_u_sum`` without a plan:
  rtol = atol = 2e-4 at ``"highest"`` and 2e-2 of max |ref| at ``"bf16"``,
  the bounds of ``tests/test_pallas_hub.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
from dgl_tpu import ops as jops
from dgl_tpu.ops import pallas_hub as jhub
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.ops import hub_cache

PLAN_FIELDS = ("hub_ids", "slots", "cold_pos", "cold_src", "cold_dst")


def _edges(kind, n, e, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, n, e), rng.integers(0, n, e)
    p = 1.0 / np.arange(1, n + 1)  # zipf-ish sources: hubs exist
    return rng.choice(n, size=e, p=p / p.sum()), rng.integers(0, n, e)


def _graphs(kind, n=3000, e=20000, seed=0):
    """The same relation on both sides. ``padded``: 333 trailing padding
    edges that point at the sink destination row (their sources in range,
    which the reference's ``HubPlan.build`` needs)."""
    if kind == "padded":
        src, dst = _edges("powerlaw", n, e, seed)
        src = np.concatenate([src, np.zeros(333, np.int64)])
        dst = np.concatenate([dst, np.full(333, n)])
        kw = dict(num_nodes=n, num_edges=e)
    else:
        src, dst = _edges(kind, n, e, seed)
        kw = dict(num_nodes=n)
    jg = dgl_tpu.graph((src, dst), **kw)
    tg = dt.graph((src, dst), device="cpu", **kw)
    return jg, tg


def _x(n, f, seed=1):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("kind,num_hubs", [
    ("powerlaw", 256), ("powerlaw", 1024), ("uniform", 256),
    ("padded", 512), ("powerlaw", 5000)])
def test_hub_plan_arrays_exact(kind, num_hubs):
    jg, tg = _graphs(kind)
    jp = jhub.HubPlan.build(jg._relation(None), num_hubs)
    tp = hub_cache.HubPlan.build(tg._relation(), num_hubs)
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.slots.dtype == torch.int32 and tp.slots.shape[1] == 1
    assert tp.slots.shape[0] % hub_cache.BLOCK_E == 0
    assert tp.num_hubs == jp.num_hubs and tp.num_hubs % hub_cache.CHUNK == 0
    assert tp.num_edges_padded == jp.num_edges_padded
    assert tp.coverage == jp.coverage
    if num_hubs >= 3000:
        assert tp.coverage == 1.0


def test_sink_padded_relation():
    """Padding edges at the sink rows (``num_src``, ``num_dst``), the
    layout the port's graphs use: the reference's ``HubPlan.build``
    indexes its slot table with the sink source and raises; the port gives
    those edges no slot and still sums the real edges exactly."""
    n, e = 500, 4000
    src, dst = _edges("powerlaw", n, e, 4)
    src = np.concatenate([src, np.full(57, n)])
    dst = np.concatenate([dst, np.full(57, n)])
    with pytest.raises(IndexError):
        jhub.HubPlan.build(dgl_tpu.graph((src, dst), num_nodes=n,
                                         num_edges=e)._relation(None), 256)
    tg = dt.graph((src, dst), num_nodes=n, num_edges=e, device="cpu")
    plan = hub_cache.HubPlan.build(tg._relation(), 256)
    assert (plan.slots[e:] == plan.num_hubs).all()
    x = torch.from_numpy(_x(n, 16, 5))
    got = hub_cache.hub_copy_u_sum(tg._relation(), x, plan=plan)
    torch.testing.assert_close(got, dt.ops.copy_u_sum(tg, x), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_hub_gather_plain_matches_pallas(dtype, precision):
    """Random slots over [0, H], the sentinel H included, on a table whose
    values are not all exact in bf16."""
    H, F, E = 512, 48, 4096
    rng = np.random.default_rng(2)
    hub = rng.normal(size=(H, F)).astype(np.float32)
    slots = rng.integers(0, H + 1, (E, 1)).astype(np.int32)
    jt = jnp.asarray(hub, jnp.dtype(dtype))
    want = np.asarray(jhub.hub_gather(jt, jnp.asarray(slots), interpret=True,
                                      precision=precision).astype(jnp.float32))
    tt = torch.from_numpy(hub).to(getattr(torch, dtype))
    got = hub_cache.hub_gather(tt, torch.from_numpy(slots),
                               precision=precision)
    assert got.dtype == tt.dtype and got.shape == (E, F)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[torch.from_numpy(slots[:, 0] == H)].any()
    # both precisions differ on an f32 table, only there
    other = hub_cache._hub_gather_plain(
        tt, torch.from_numpy(slots),
        "bf16" if precision == "highest" else "highest")
    assert torch.equal(other, got) == (dtype == "bfloat16")


def test_hub_gather_zero_for_sentinel():
    """``tests/test_pallas_hub.py::test_hub_gather_zero_for_sentinel``
    on the port: one slot set, every other the sentinel."""
    H, F = 256, 128
    hub = np.random.default_rng(0).normal(size=(H, F)).astype(np.float32)
    slots = np.full((2048, 1), H, np.int32)
    slots[0, 0] = 3
    want = np.asarray(jhub.hub_gather(jnp.asarray(hub), jnp.asarray(slots),
                                      interpret=True))
    out = hub_cache.hub_gather(torch.from_numpy(hub),
                               torch.from_numpy(slots))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(out[0].numpy(), hub[3])
    assert float(out[1:].abs().max()) == 0.0


@pytest.mark.parametrize("kind,num_hubs,precision", [
    ("powerlaw", 256, "highest"), ("powerlaw", 1024, "highest"),
    ("powerlaw", 512, "bf16"), ("uniform", 256, "highest"),
    ("padded", 256, "highest"), ("padded", 256, "bf16")])
def test_hub_copy_u_sum_matches(kind, num_hubs, precision):
    jg, tg = _graphs(kind, seed=3)
    jrel, trel = jg._relation(None), tg._relation()
    x = _x(3000, 40, 7)  # F = 40: the reference pads it to 128 lanes
    jp = jhub.HubPlan.build(jrel, num_hubs)
    run = jax.jit(lambda x: jhub.hub_copy_u_sum(
        jrel, x, plan=jp, interpret=True, precision=precision))
    want = np.asarray(run(jnp.asarray(x)))
    _kernels.reset_launch_counts()
    with torch.no_grad():
        got = hub_cache.hub_copy_u_sum(trel, torch.from_numpy(x),
                                       num_hubs=num_hubs,
                                       precision=precision).numpy()
    assert _kernels.launch_counts["hub_gather"] == 0  # plain on the CPU
    assert got.shape == (3000, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = np.asarray(jops.copy_u_sum(jg, jnp.asarray(x)))
    np.testing.assert_allclose(
        dt.ops.copy_u_sum(tg, torch.from_numpy(x)).numpy(), exact,
        rtol=1e-5, atol=1e-5)
    if precision == "highest":
        np.testing.assert_allclose(got, exact, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(got - exact).max() < 2e-2 * np.abs(exact).max()


def test_shape_errors_match():
    """Both packages refuse the same shapes with the same message."""
    hub = np.zeros((256, 8), np.float32)
    for H, E in ((300, 2048), (256, 1000)):
        h = np.zeros((H, 8), np.float32)
        s = np.zeros((E, 1), np.int32)
        with pytest.raises(ValueError) as jerr:
            jhub.hub_gather(jnp.asarray(h), jnp.asarray(s), interpret=True)
        with pytest.raises(ValueError) as terr:
            hub_cache.hub_gather(torch.from_numpy(h), torch.from_numpy(s))
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="precision"):
        hub_cache.hub_gather(torch.from_numpy(hub),
                             torch.zeros((2048, 1), dtype=torch.int32),
                             precision="fp8")


def test_grad_guard():
    """No gradient on either side: ``jax.grad`` through the reference's
    ``pallas_call`` fails, and the port raises instead of detaching."""
    jg, tg = _graphs("powerlaw", n=600, e=3000, seed=9)
    x = torch.from_numpy(_x(600, 8, 9))
    rel = tg._relation()
    with pytest.raises(RuntimeError, match="no gradient"):
        hub_cache.hub_copy_u_sum(rel, x.requires_grad_(), num_hubs=256)
    with torch.no_grad():
        out = hub_cache.hub_copy_u_sum(rel, x, num_hubs=256)
    assert out.grad_fn is None
    out2 = hub_cache.hub_copy_u_sum(rel, x.detach(), num_hubs=256)
    torch.testing.assert_close(out, out2)
    jrel = jg._relation(None)
    with pytest.raises(Exception):
        jax.grad(lambda x: jhub.hub_copy_u_sum(
            jrel, x, num_hubs=256, interpret=True).sum())(
                jnp.asarray(x.detach().numpy()))
