"""The exact (f32) plan modes of the port against ``dgl_tpu``.

- ``build_hub_plan`` for every ``(precision, cold)`` pair the reference
  takes: every array (``a_hub`` with its type, the hub ids, the four cold
  arrays, the shells, residuals and unranks) and the coverage exactly
  equal, and the same errors.
- ``hub_copy_u_sum`` forward and gradient: rtol = 1e-5,
  atol = 1e-5 * max|ref| in the two exact modes (``("f32", "f32")`` and
  ``("f32", "shell-f32")``: the same f32 terms summed in another order; the
  reference's own ``test_shell_forward_and_grad`` normalises by max|ref|
  too, since a zipf hub's row sums hundreds of terms), 1e-4 where rows are
  rounded to bf16. The
  reference runs under ``jax.jit`` compiled with
  ``xla_allow_excess_precision`` off: XLA's CPU otherwise skips the bf16
  roundings of ``cold="bf16"`` and ``"shell"``.
- ``reorder_for_spmm``/``with_spmm_plans(precision="f32")`` through
  ``ops.copy_u_sum``/``copy_u_mean`` and a 2-layer GraphSAGE on the
  reference's weights (``from_flax_params``): rtol = 1e-5,
  atol = 1e-5 * max|ref| (the models' f32 matmuls differ in the last bit).
- The exact bitmap SpMM (``compute_dtype="float32"``): forward and VJP at
  1e-5, and the plain version against the reference's Pallas kernel in
  interpret mode.
- The f32 hub matmul runs at precision ``"highest"`` whatever the
  process's TF32 setting, which is restored after it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.bitmap_spmm as jbs
from dgl_tpu.base import DGLError as JDGLError
from dgl_tpu.models import GraphSAGE as JGraphSAGE
from dgl_tpu.ops.hub_spmm import build_hub_plan as j_build_hub_plan
from dgl_tpu.ops.hub_spmm import hub_copy_u_sum as j_hub_copy_u_sum
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.models import GraphSAGE
from dgl_tpu_torch.ops import bitmap_spmm as tb
from dgl_tpu_torch.ops import hub_spmm
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum

PRECISIONS = ("int8", "bf16", "f32")
COLDS = ("shell", "shell-f32", "bf16", "f32")
EXACT = (("f32", "f32"), ("f32", "shell-f32"))
N, E = 1500, 12000


def _graph_edges(n=N, e=E, seed=21):
    """zipf sources (hubs), skewed destinations: some pass the shell cap
    of 32 in-edges, so the shell plans have a residual and an unrank."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum())
    return src, dst


@pytest.fixture(scope="module")
def rels():
    src, dst = _graph_edges()
    return (dgl_tpu.graph((src, dst), num_nodes=N)._relation(),
            dt.graph((src, dst), num_nodes=N, device="cpu")._relation())


def _np(t):
    return None if t is None else t.to(torch.float32).numpy()


def _assert_plans_equal(tp, jp):
    assert (tp.precision, tp.cold, tp.num_hubs, tp.num_src, tp.num_dst) == (
        jp.precision, jp.cold, jp.num_hubs, jp.num_src, jp.num_dst)
    assert tp.coverage == jp.coverage
    assert f"cold={jp.cold}" in repr(tp)
    assert tp.a_hub.dtype == {"int8": torch.int8, "bf16": torch.bfloat16,
                              "f32": torch.float32}[jp.precision]
    np.testing.assert_array_equal(_np(tp.a_hub),
                                  np.asarray(jp.a_hub, np.float32))
    for f in ("hub_ids", "cold_src", "cold_dst", "rev_src", "rev_dst"):
        a, b = getattr(tp, f), np.asarray(getattr(jp, f))
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    for f in ("shells", "rev_shells"):
        ts, js = getattr(tp, f), getattr(jp, f)
        assert len(ts) == len(js), f
        for (ti, tm), (ji, jm) in zip(ts, js):
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(_np(tm), np.asarray(jm, np.float32))
    for f in ("res_dst", "res_src"):
        ta, ja = getattr(tp, f), getattr(jp, f)
        assert (ta is None) == (ja is None), f
        for a, b in zip(ta or (), ja or ()):
            np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    for f in ("unrank_dst", "unrank_src"):
        ta, ja = getattr(tp, f), getattr(jp, f)
        assert (ta is None) == (ja is None), f
        if ta is not None:
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("cold", COLDS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_hub_plan_arrays_exact(rels, precision, cold):
    jrel, trel = rels
    jp = j_build_hub_plan(jrel, 128, precision, cold=cold)
    tp = build_hub_plan(trel, 128, precision, cold=cold)
    _assert_plans_equal(tp, jp)
    shells = cold in ("shell", "shell-f32")
    assert bool(tp.shells) == shells and bool(tp.rev_shells) == shells
    assert (tp.res_dst is not None) == shells  # the skewed destinations
    assert (tp.shell_idx is not None) == shells
    # the cold arrays' lengths count the real cold edges
    n_cold = int((tp.cold_dst < N).sum())
    assert tp.num_cold == n_cold > 0
    assert int(tp.cold_len.sum()) == int(tp.rev_len.sum()) == n_cold
    # the plan moves with its cold arrays
    moved = tp.to("cpu")
    for f in ("cold_src", "cold_dst", "rev_src", "rev_dst", "cold_len",
              "rev_len"):
        assert torch.equal(getattr(moved, f), getattr(tp, f))
    assert moved.cold == cold


def test_hub_plan_defaults_and_errors(rels):
    jrel, trel = rels
    for precision, cold in (("int8", "shell"), ("bf16", "shell"),
                            ("f32", "f32")):
        assert build_hub_plan(trel, 128, precision).cold == cold
        assert j_build_hub_plan(jrel, 128, precision).cold == cold
    for kw, what in (({"precision": "f16"}, "precision"),
                     ({"cold": "shell-bf16"}, "cold")):
        with pytest.raises(JDGLError) as jerr:
            j_build_hub_plan(jrel, 128, **kw)
        with pytest.raises(DGLError) as terr:
            build_hub_plan(trel, 128, **kw)
        assert str(terr.value) == str(jerr.value) and what in str(terr.value)


def _ref_vjp(plan, x, cot):
    """The reference's ``hub_copy_u_sum`` and its gradient of
    ``sum(out * cot)``, compiled with excess precision off."""
    def both(x, cot):
        out, pull = jax.vjp(lambda v: j_hub_copy_u_sum(plan, v), x)
        return out, pull(cot)[0]

    args = (jnp.asarray(x), jnp.asarray(cot))
    out, grad = jax.jit(both).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    return np.asarray(out), np.asarray(grad)


def _port_vjp(plan, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    out = hub_copy_u_sum(plan, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _tol(precision, cold):
    return 1e-5 if (precision, cold) in EXACT else 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("cold", COLDS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_hub_copy_u_sum_and_grad_match(rels, precision, cold):
    jrel, trel = rels
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, 24)).astype(np.float32)
    cot = rng.normal(size=(N, 24)).astype(np.float32)
    jp = j_build_hub_plan(jrel, 128, precision, cold=cold)
    tp = build_hub_plan(trel, 128, precision, cold=cold)
    ref, ref_grad = _ref_vjp(jp, x, cot)
    _kernels.reset_launch_counts()
    out, grad = _port_vjp(tp, x, cot)
    assert not any(_kernels.launch_counts.values())  # CPU: plain versions
    _close(out, ref, _tol(precision, cold))
    _close(grad, ref_grad, _tol(precision, cold))


def _b1_calls(monkeypatch):
    """Count the calls of B1's wrapper from the hub SpMM, by table type."""
    calls = []
    orig = hub_spmm.shell_prefix_sum

    def count(table, *a, **k):
        calls.append(table.dtype)
        return orig(table, *a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", count)
    return calls


@pytest.mark.parametrize("cold", ["f32", "shell-f32", "bf16", "shell"])
def test_cold_modes_route(rels, monkeypatch, cold):
    """The shell modes call B1 once a direction, with an f32 table under
    ``"shell-f32"`` and a bf16 one under ``"shell"``; the segment modes
    never call it."""
    _jrel, trel = rels
    calls = _b1_calls(monkeypatch)
    x = torch.randn(N, 8, requires_grad=True)
    hub_copy_u_sum(build_hub_plan(trel, 128, "f32", cold=cold), x).sum(
        ).backward()
    want = {"shell-f32": [torch.float32] * 2,
            "shell": [torch.bfloat16] * 2}.get(cold, [])
    assert calls == want


@pytest.mark.parametrize("cold", ["f32", "shell-f32"])
def test_padded_graph(cold):
    """Padding edges (src == num_src, dst == num_dst) drop in every
    array and sum."""
    src = np.array([0, 1, 1, 2, 5, 5])
    dst = np.array([1, 2, 0, 0, 5, 5])
    jrel = dgl_tpu.graph((src, dst), num_nodes=5, num_edges=4)._relation()
    trel = dt.graph((src, dst), num_nodes=5, num_edges=4,
                    device="cpu")._relation()
    jp = j_build_hub_plan(jrel, 2, "f32", cold=cold)
    tp = build_hub_plan(trel, 2, "f32", cold=cold)
    _assert_plans_equal(tp, jp)
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    cot = np.linspace(-1, 1, 15, dtype=np.float32).reshape(5, 3)
    ref, ref_grad = _ref_vjp(jp, x, cot)
    out, grad = _port_vjp(tp, x, cot)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cold", ["f32", "shell-f32"])
def test_all_hub_graph(cold):
    """Every source a hub: no cold edge, no shell, the hub matmul alone."""
    src, dst = _graph_edges(100, 900, 2)
    jrel = dgl_tpu.graph((src, dst), num_nodes=100)._relation()
    trel = dt.graph((src, dst), num_nodes=100, device="cpu")._relation()
    jp = j_build_hub_plan(jrel, 100, "f32", cold=cold)
    tp = build_hub_plan(trel, 100, "f32", cold=cold)
    _assert_plans_equal(tp, jp)
    assert tp.coverage == 1.0 and tp.num_cold == 0 and not tp.shells
    rng = np.random.default_rng(2)
    x = rng.normal(size=(100, 16)).astype(np.float32)
    cot = rng.normal(size=(100, 16)).astype(np.float32)
    ref, ref_grad = _ref_vjp(jp, x, cot)
    out, grad = _port_vjp(tp, x, cot)
    _close(out, ref, 1e-5)
    _close(grad, ref_grad, 1e-5)


@pytest.mark.parametrize("shape", [(N,), (N, 16), (N, 4, 8)])
@pytest.mark.parametrize("cold", ["f32", "shell-f32"])
def test_feature_ranks(rels, cold, shape):
    jrel, trel = rels
    jp = j_build_hub_plan(jrel, 128, "f32", cold=cold)
    tp = build_hub_plan(trel, 128, "f32", cold=cold)
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    ref, ref_grad = _ref_vjp(jp, x, cot)
    out, grad = _port_vjp(tp, x, cot)
    assert out.shape == shape
    _close(out, ref, 1e-5)
    _close(grad, ref_grad, 1e-5)


def test_reorder_and_with_spmm_plans_f32():
    """Under ``precision="f32"`` the default cold tail has no shells, so
    ``unrank_dst`` is None and ``reorder_for_spmm`` keeps the node order
    on both sides; both graphs then aggregate through the f32 plan."""
    src, dst = _graph_edges()
    jg = dgl_tpu.graph((src, dst), num_nodes=N)
    tg = dt.graph((src, dst), num_nodes=N, device="cpu")
    jg2, jperm = dgl_tpu.transforms.reorder_for_spmm(jg, num_hubs=128,
                                                     precision="f32")
    tg2, tperm = dt.transforms.reorder_for_spmm(tg, num_hubs=128,
                                                precision="f32")
    np.testing.assert_array_equal(tperm, np.asarray(jperm))
    np.testing.assert_array_equal(tperm, np.arange(N))
    _assert_plans_equal(tg2._relation().hub_plan, jg2._relation().hub_plan)
    tgp = tg.with_spmm_plans(num_hubs=128, precision="f32")
    jgp = jg.with_spmm_plans(num_hubs=128, precision="f32")
    assert tgp._relation().bitmap_plan is None
    _assert_plans_equal(tgp._relation().hub_plan, jgp._relation().hub_plan)
    x = np.random.default_rng(6).normal(size=(N, 12)).astype(np.float32)
    for op in ("copy_u_sum", "copy_u_mean"):
        exact = getattr(dt.ops, op)(tg, torch.from_numpy(x)).numpy()
        ref = np.asarray(getattr(dgl_tpu.ops, op)(jgp, jnp.asarray(x)))
        for g in (tgp, tg2):
            out = getattr(dt.ops, op)(g, torch.from_numpy(x)).numpy()
            _close(out, ref, 1e-5)
            _close(out, exact, 1e-5)


def test_graphsage_on_f32_plan_matches():
    """GraphSAGE 16 -> 32 -> 8 (mean), the reference's weights carried by
    ``from_flax_params``, on both sides' f32 plans."""
    src, dst = _graph_edges()
    x = np.random.default_rng(7).normal(size=(N, 16)).astype(np.float32)
    jg = dgl_tpu.graph((src, dst), num_nodes=N).with_spmm_plans(
        num_hubs=128, precision="f32")
    tg = dt.graph((src, dst), num_nodes=N, device="cpu").with_spmm_plans(
        num_hubs=128, precision="f32")
    jmodel = JGraphSAGE(16, 32, 8, num_layers=2)
    params = jmodel.init(jax.random.PRNGKey(3), jg, jnp.asarray(x))
    ref = np.asarray(jax.jit(jmodel.apply)(params, jg, jnp.asarray(x)))
    model = GraphSAGE(16, 32, 8, num_layers=2, device="cpu")
    model.load_state_dict(dt.from_flax_params(params))
    with torch.inference_mode():
        out = model.eval()(tg, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (N, 8)
    _close(out, ref, 1e-5)


def test_f32_matmul_runs_at_highest(rels, monkeypatch):
    """``torch.backends.cuda.matmul.allow_tf32 = True`` set in the process
    does not reach the f32 hub matmul, and is restored after it."""
    _jrel, trel = rels
    plan = build_hub_plan(trel, 128, "f32")
    seen = []
    mm = torch.mm

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return mm(*a, **k)

    monkeypatch.setattr(torch, "mm", spy)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        x = torch.randn(N, 8, requires_grad=True)
        hub_copy_u_sum(plan, x).sum().backward()
        assert seen == ["highest", "highest"]  # forward, backward
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _tf32_readings():
    """Every reading of the TF32 setting, a failed one as "raises"."""
    out = []
    for read in (lambda: torch.backends.cuda.matmul.allow_tf32,
                 torch.get_float32_matmul_precision,
                 lambda: getattr(torch.backends.cuda.matmul,
                                 "fp32_precision", None),
                 lambda: getattr(getattr(torch.backends.mkldnn, "matmul",
                                         None), "fp32_precision", None)):
        try:
            out.append(read())
        except RuntimeError:
            out.append("raises")
    return out


@pytest.mark.parametrize("setup", [
    "allow_tf32", "high", "high_then_allow_tf32_off", "fp32_precision"])
def test_full_f32_restores_the_setting(setup):
    """Whatever way a process set TF32 (the process-wide value, or since
    PyTorch 2.9 a backend's own), ``full_f32`` runs its block at
    ``"highest"`` with both in agreement (a matmul refuses to run while
    they disagree) and puts every reading back as it was, a reading that
    raised before included."""
    from dgl_tpu_torch.ops._precision import full_f32

    cuda = torch.backends.cuda.matmul
    if setup == "fp32_precision" and not hasattr(cuda, "fp32_precision"):
        pytest.skip("PyTorch before 2.9 has no per-backend setting")
    try:
        if setup == "allow_tf32":
            cuda.allow_tf32 = True
        elif setup == "high":
            torch.set_float32_matmul_precision("high")
        elif setup == "high_then_allow_tf32_off":
            torch.set_float32_matmul_precision("high")
            cuda.allow_tf32 = False
        else:
            cuda.fp32_precision = "tf32"
        before = _tf32_readings()
        for _ in range(2):
            with full_f32():
                inside = _tf32_readings()
                assert inside[:2] == [False, "highest"]
            assert _tf32_readings() == before
    finally:
        torch.set_float32_matmul_precision("highest")
        for backend in (cuda, getattr(torch.backends.mkldnn, "matmul", None)):
            if hasattr(backend, "fp32_precision"):
                backend.fp32_precision = "none"


# ---------------------------------------------------------------------------
# the exact bitmap SpMM (B2 in f32)
# ---------------------------------------------------------------------------


def _simple_edges(n_src, n_dst, e, seed):
    rng = np.random.default_rng(seed)
    flat = np.unique(rng.integers(0, n_dst, e).astype(np.int64) * n_src
                     + rng.integers(0, n_src, e))
    return (flat % n_src).astype(np.int64), (flat // n_src).astype(np.int64)


def _bitmap_pair(n_src, n_dst, e, seed):
    src, dst = _simple_edges(n_src, n_dst, e, seed)
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = dt.Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    return (jbs.build_bitmap_plan(jrel, compute_dtype="float32"),
            tb.build_bitmap_plan(trel, compute_dtype="float32"))


@pytest.mark.parametrize("feat", [16, 41])
def test_bitmap_f32_forward_and_vjp(feat):
    jp, tp = _bitmap_pair(4200, 900, 60000, 2)
    np.testing.assert_array_equal(np.asarray(jp.bits), tp.bits.numpy())
    rng = np.random.default_rng(3)
    u = rng.normal(size=(4200, feat)).astype(np.float32)
    cot = rng.normal(size=(900, feat)).astype(np.float32)
    ref, pull = jax.vjp(lambda v: jbs.bitmap_copy_u_sum(jp, v),
                        jnp.asarray(u))
    ref_grad = pull(jnp.asarray(cot))[0]
    ut = torch.from_numpy(u).requires_grad_()
    _kernels.reset_launch_counts()
    out = tb.bitmap_copy_u_sum(tp, ut)
    (out * torch.from_numpy(cot)).sum().backward()
    assert not any(_kernels.launch_counts.values())  # CPU: plain version
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-5)
    # exact f32, not the bf16-rounded rows of the default plan
    bf = tb.bitmap_matmul_plain(tp.bits, torch.from_numpy(u), 900)
    assert not np.allclose(bf.numpy(), np.asarray(ref), rtol=1e-5,
                           atol=1e-5)


def test_bitmap_f32_plain_matches_pallas_interpret():
    jp, tp = _bitmap_pair(700, 600, 9000, 12)
    u = np.random.default_rng(13).normal(size=(700, 20)).astype(np.float32)
    up = jnp.pad(jnp.asarray(u), ((0, jp.bits.shape[1] * 8 - 700), (0, 0)))
    jbs._FORCE_PALLAS_INTERPRET = True
    try:
        ref = jbs._bitmap_matmul_pallas(jp.bits, up, jnp.float32)
    finally:
        jbs._FORCE_PALLAS_INTERPRET = False
    out = tb.bitmap_matmul_plain(tp.bits, torch.from_numpy(u), 600,
                                 compute_dtype="float32")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:600],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="float16"):
        tb.bitmap_matmul(tp.bits, torch.from_numpy(u), 600,
                         compute_dtype="float16")


def test_bitmap_f32_gspmm_dispatch():
    """A float32 plan attached with ``Relation.with_bitmap_plan`` carries
    ``copy_u_sum``/``copy_u_mean`` and their gradients at f32 rounding of
    the exact path."""
    n = 600
    src, dst = _simple_edges(n, n, 30000, 7)
    g = dt.graph((src, dst), num_nodes=n, device="cpu")
    rel = g._relation()
    plan = tb.build_bitmap_plan(rel, compute_dtype="float32")
    gp = g.structural_clone()
    gp._relations = {k: r.with_bitmap_plan(plan)
                     for k, r in g._relations.items()}
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(n, 12)).astype(np.float32))
    for op in ("copy_u_sum", "copy_u_mean"):
        xa = x.clone().requires_grad_()
        xb = x.clone().requires_grad_()
        out = getattr(dt.ops, op)(gp, xa)
        exact = getattr(dt.ops, op)(g, xb)
        (out * out.detach()).sum().backward()
        (exact * out.detach()).sum().backward()
        torch.testing.assert_close(out, exact, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
