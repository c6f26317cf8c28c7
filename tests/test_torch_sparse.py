"""The port's sparse-matrix API (``dgl_tpu_torch.sparse``) against
``dgl_tpu.sparse``: every name of ``dgl_tpu.sparse.__all__`` but
``from_bcoo``/``to_bcoo`` (which take and give a JAX ``BCOO``; the port's
interchange is ``from_torch_sparse``/``to_torch_sparse_*``), on scalar and
(nnz, H) values, rectangular shapes, duplicate entries and a padded
graph's ``adj()``; the gradients of ``spmm``, ``bspmm``, ``sddmm``,
``softmax`` and the reductions; and DGL's sparse-API GCN
(``examples/sparse/gcn.py``) end to end, forward and gradients, also held
against three ``GraphConv(norm="both")`` layers on the same graph plus
self-loops.

Every input is made once with numpy from a seed and handed to both sides.
Where the reference raises, the port must raise too.

Tolerances: indices, shapes and dtypes exact; values rtol = atol = 1e-5
(the same f32 operations, sums in other orders); the GCN against
GraphConv rtol = 1e-4, atol = 1e-4 * max|ref| (another order of the same
f32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import dgl_tpu
from dgl_tpu import sparse as jsp
import dgl_tpu_torch as dt
from dgl_tpu_torch import sparse as tsp

TOL = dict(rtol=1e-5, atol=1e-5)
N, M, H = 7, 5, 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _edges(seed, n, m, e, dups=3):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, m, e)
    return np.concatenate([r, r[:dups]]), np.concatenate([c, c[:dups]])


def _padded_graph_arrays(n=6, e=14, pad=3, seed=7):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    dst = np.concatenate([rng.integers(0, n, e), np.full(pad, n)])
    return src, dst, n, e


def _mats(sp, arr, graph_adj):
    """The matrices each case draws on, built by module ``sp``."""
    ra, ca = _edges(0, N, M, 12)
    rb, cb = _edges(1, N, M, 9, dups=0)
    rng = np.random.default_rng(2)
    va = rng.normal(size=ra.shape[0]).astype(np.float32)
    vb = rng.normal(size=rb.shape[0]).astype(np.float32)
    vh = rng.normal(size=(ra.shape[0], H)).astype(np.float32)
    rs, cs = np.nonzero(rng.random((6, 6)) < 0.4)
    vs = rng.uniform(0.5, 2.0, rs.shape[0]).astype(np.float32)
    dvals = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    return {
        "A": sp.from_coo(arr(ra), arr(ca), arr(va), (N, M)),
        "A2": sp.from_coo(arr(ra), arr(ca), arr(2 * va + 1), (N, M)),
        "B": sp.from_coo(arr(rb), arr(cb), arr(vb), (N, M)),
        "H": sp.from_coo(arr(ra), arr(ca), arr(vh), (N, M)),
        "S": sp.from_coo(arr(rs), arr(cs), arr(vs), (6, 6)),
        "D": sp.diag(arr(dvals)),
        "P": graph_adj,
        "ones": sp.from_coo(arr(ra), arr(ca), None, (N, M)),
    }


def _cpu(sp):
    """The port's constructors of numpy data default to the card."""
    return {"device": "cpu"} if sp is tsp else {}


def _dense(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# each case: (sp, M, arr) -> output; sp is dgl_tpu.sparse or
# dgl_tpu_torch.sparse, M its matrices, arr its array constructor
CASES = {
    "SparseMatrix.props": lambda sp, M, arr: (
        M["A"].shape, M["A"].nnz, M["A"].row, M["A"].col, M["A"].val,
        M["A"].indices(), *M["A"].csr(), *M["A"].csc()),
    "to_dense": lambda sp, M, arr: M["A"].to_dense(),
    "to_dense_vector": lambda sp, M, arr: M["H"].to_dense(),
    "to_dense_padded": lambda sp, M, arr: M["P"].to_dense(),
    "transpose": lambda sp, M, arr: (M["A"].T, M["A"].t().to_dense()),
    "spmatrix": lambda sp, M, arr: sp.spmatrix(
        arr(np.array([0, 2, 2])), arr(np.array([1, 0, 1]))),
    "from_coo_inferred_shape": lambda sp, M, arr: sp.from_coo(
        arr(np.array([3, 0, 1])), arr(np.array([1, 4, 1])),
        arr(np.array([1.0, 2.0, 3.0], np.float32))),
    "from_csr": lambda sp, M, arr: sp.from_csr(
        np.array([0, 2, 2, 5]), np.array([1, 3, 0, 0, 2]),
        arr(np.arange(5, dtype=np.float32)), (3, 4)),
    "from_csc": lambda sp, M, arr: sp.from_csc(
        np.array([0, 1, 3, 3]), np.array([2, 0, 2]),
        arr(np.arange(3, dtype=np.float32))),
    "val_like": lambda sp, M, arr: sp.val_like(
        M["A"], arr(_dense(3, M["A"].nnz))),
    "diag_rect": lambda sp, M, arr: sp.diag(
        arr(np.arange(1, 4, dtype=np.float32)), (3, 5)),
    "identity": lambda sp, M, arr: sp.identity((4, 6), **_cpu(sp)),
    "identity_d": lambda sp, M, arr: sp.identity((3, 3), d=2, **_cpu(sp)),
    "add_same_pattern": lambda sp, M, arr: sp.add(M["A"], M["A2"]),
    "add_merge": lambda sp, M, arr: sp.add(M["A"], M["B"]),
    "sub_merge": lambda sp, M, arr: sp.sub(M["A"], M["B"]),
    "sp_add": lambda sp, M, arr: sp.sp_add(M["B"], M["A"]),
    "sp_sub": lambda sp, M, arr: sp.sp_sub(M["A"], M["A2"]),
    "spsp_add": lambda sp, M, arr: sp.spsp_add(M["A"], M["B"]),
    "add_padded_raises": lambda sp, M, arr: sp.add(M["P"], sp.identity(
        (6, 6), **_cpu(sp))),
    "mul_scalar": lambda sp, M, arr: (sp.mul(M["A"], 2.5), 3 * M["H"]),
    "mul_dense_per_nnz": lambda sp, M, arr: sp.mul(
        M["A"], arr(_dense(4, M["A"].nnz))),
    "mul_mismatch_raises": lambda sp, M, arr: sp.mul(M["A"], M["B"]),
    "div": lambda sp, M, arr: (sp.div(M["A"], 4.0), sp.div(M["A"],
                                                           M["A2"])),
    "sp_mul": lambda sp, M, arr: sp.sp_mul(M["A"], M["A2"]),
    "sp_div": lambda sp, M, arr: sp.sp_div(M["H"], 2.0),
    "power": lambda sp, M, arr: (sp.power(M["S"], 2), M["S"] ** -0.5),
    "sp_power": lambda sp, M, arr: sp.sp_power(M["S"], 3),
    "neg": lambda sp, M, arr: (sp.neg(M["H"]), -M["A"]),
    "inv": lambda sp, M, arr: sp.inv(M["D"]),
    "inv_raises": lambda sp, M, arr: sp.inv(M["S"]),
    "spsp_mul_same": lambda sp, M, arr: sp.spsp_mul(M["A"], M["A2"]),
    "spsp_mul_intersection": lambda sp, M, arr: sp.spsp_mul(M["A"], M["B"]),
    "spsp_div": lambda sp, M, arr: sp.spsp_div(M["A"], M["A2"]),
    "coalesce": lambda sp, M, arr: (M["A"].coalesce(), M["H"].coalesce(),
                                    M["A"].has_duplicate(),
                                    M["B"].has_duplicate()),
    "coalesce_padded_raises": lambda sp, M, arr: M["P"].coalesce(),
    "is_diag": lambda sp, M, arr: (M["D"].is_diag(), M["S"].is_diag(),
                                   M["P"].is_diag()),
    "spmm": lambda sp, M, arr: sp.spmm(M["A"], arr(_dense(5, M_, 4))),
    "spmm_padded": lambda sp, M, arr: sp.spmm(M["P"], arr(_dense(6, 6, 3))),
    "matmul_dense": lambda sp, M, arr: (M["A"] @ arr(_dense(5, M_, 4)),
                                        sp.matmul(M["S"], arr(_dense(
                                            7, 6, 2)))),
    "bspmm": lambda sp, M, arr: sp.bspmm(M["H"], arr(_dense(8, M_, 2, H))),
    "matmul_batched": lambda sp, M, arr: M["H"] @ arr(_dense(8, M_, 2, H)),
    "spmm_vector_raises": lambda sp, M, arr: sp.spmm(M["H"], arr(_dense(
        5, M_, 4))),
    "spspmm": lambda sp, M, arr: sp.spspmm(M["A"], M["B"].T),
    "spspmm_square": lambda sp, M, arr: M["D"] @ M["S"] @ M["D"],
    "spspmm_padded_raises": lambda sp, M, arr: sp.spspmm(M["P"], M["S"]),
    "sddmm": lambda sp, M, arr: sp.sddmm(M["A"], arr(_dense(9, N, 4)),
                                         arr(_dense(10, 4, M_))),
    "sddmm_padded": lambda sp, M, arr: sp.sddmm(M["P"], arr(_dense(
        9, 6, 4)), arr(_dense(10, 4, 6))),
    "bsddmm": lambda sp, M, arr: sp.bsddmm(M["H"], arr(_dense(11, N, 4, H)),
                                           arr(_dense(12, 4, M_, H))),
    "softmax": lambda sp, M, arr: (sp.softmax(M["A"]),
                                   M["A"].softmax(0), sp.softmax(M["H"], 0)),
    "softmax_padded": lambda sp, M, arr: (sp.softmax(
        sp.val_like(M["P"], arr(_dense(13, M["P"].val.shape[0])))),
        M["P"].softmax(0)),
    "is_scalar": lambda sp, M, arr: (sp.is_scalar(3), sp.is_scalar(2.0),
                                     sp.is_scalar(arr(np.float32(1.0))),
                                     sp.is_scalar(arr(np.ones(2))),
                                     sp.is_scalar("a")),
    "sp_broadcast_v_rows": lambda sp, M, arr: (
        sp.sp_broadcast_v(M["A"], arr(_dense(14, N)), "add"),
        sp.sp_broadcast_v(M["H"], arr(_dense(15, N, H)), "mul")),
    "sp_add_v": lambda sp, M, arr: sp.sp_add_v(M["A"], arr(_dense(14, N,
                                                                  1))),
    "sp_sub_v": lambda sp, M, arr: sp.sp_sub_v(M["A"], arr(_dense(16, 1,
                                                                  M_))),
    "sp_mul_v": lambda sp, M, arr: sp.sp_mul_v(M["H"], arr(_dense(17, N,
                                                                  1))),
    "sp_div_v": lambda sp, M, arr: sp.sp_div_v(M["S"], arr(
        np.random.default_rng(18).uniform(1, 2, (1, 6)).astype(np.float32))),
    "sp_add_v_padded": lambda sp, M, arr: (
        sp.sp_add_v(M["P"], arr(_dense(19, 6))),
        sp.sp_mul_v(M["P"], arr(_dense(20, 1, 6)))),
    "sp_broadcast_v_raises": lambda sp, M, arr: sp.sp_add_v(
        M["A"], arr(_dense(14, 3, 2))),
    "from_scipy": lambda sp, M, arr: sp.from_scipy(sps.random(
        6, 8, density=0.3, format="csr", dtype=np.float32, random_state=3),
        **_cpu(sp)),
    "to_scipy": lambda sp, M, arr: sp.to_scipy(M["A"]).toarray(),
    "from_torch_sparse": lambda sp, M, arr: [sp.from_torch_sparse(t) for t in
                                             _torch_sparse_inputs()],
    "to_torch_sparse_coo": lambda sp, M, arr:
        sp.to_torch_sparse_coo(M["A"]).coalesce().to_dense(),
    "to_torch_sparse_csr": lambda sp, M, arr:
        sp.to_torch_sparse_csr(M["A"]).to_dense(),
    "to_torch_sparse_csc": lambda sp, M, arr:
        sp.to_torch_sparse_csc(M["A"]).to_dense(),
}
M_ = M

for op in ("sum", "smax", "smin", "smean", "sprod"):
    for dim in (None, 0, 1):
        for key in ("A", "H", "S", "P"):
            CASES[f"{op}_dim{dim}_{key}"] = (
                lambda sp, Ms, arr, op=op, dim=dim, key=key:
                getattr(sp, op)(Ms[key], dim))
CASES["reduce"] = lambda sp, M, arr: (sp.reduce(M["A"], "smean", 1),
                                      sp.sp_reduce(M["H"], "smax", 0),
                                      M["S"].reduce("sprod", 0),
                                      M["A"].sum(), M["H"].smin(1))


def _torch_sparse_inputs():
    rng = np.random.default_rng(21)
    d = (rng.random((5, 4)) < 0.4) * rng.normal(size=(5, 4))
    t = torch.from_numpy(d.astype(np.float32))
    return [t.to_sparse_coo(), t.to_sparse_csr(), t.to_sparse_csc()]


def test_every_reference_name_has_a_port_and_a_case():
    names = set(jsp.__all__) - {"from_bcoo", "to_bcoo"}
    assert names <= set(tsp.__all__)
    assert not {"from_bcoo", "to_bcoo"} & set(tsp.__all__)
    covered = " ".join(CASES)
    for name in names - {"SparseMatrix", "sp_reduce", "matmul"}:
        assert name in covered, name


@pytest.fixture(scope="module")
def mats():
    src, dst, n, e = _padded_graph_arrays()
    jg = dgl_tpu.graph((src, dst), num_nodes=n, num_edges=e)
    tg = dt.graph((src, dst), num_nodes=n, num_edges=e, device="cpu")
    jm = _mats(jsp, jnp.asarray, jg.adj())
    tm = _mats(tsp, lambda a: torch.from_numpy(np.asarray(a)), tg.adj())
    return jm, tm


def _compare(got, ref, path="out"):
    if isinstance(ref, jsp.SparseMatrix):
        assert isinstance(got, tsp.SparseMatrix), path
        assert got.shape == ref.shape and got.nnz == ref.nnz, path
        for f in ("row", "col"):
            r, g = np.asarray(getattr(ref, f)), _np(getattr(got, f))
            assert g.dtype == r.dtype and np.array_equal(g, r), (path, f)
        np.testing.assert_allclose(_np(got.val), np.asarray(ref.val),
                                   err_msg=path, **TOL)
    elif isinstance(ref, (tuple, list)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _compare(a, b, f"{path}[{i}]")
    elif isinstance(ref, (bool, int, float, str, np.bool_)):
        assert got == ref, path
    elif isinstance(ref, torch.Tensor):
        np.testing.assert_allclose(_np(got), _np(ref), err_msg=path, **TOL)
    else:
        r, g = np.asarray(ref), _np(got)
        assert g.shape == r.shape, (path, g.shape, r.shape)
        if r.dtype.kind in "iub":
            assert np.array_equal(g, r), path
        else:
            np.testing.assert_allclose(g, r, err_msg=path, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_op_matches(case, mats):
    jm, tm = mats
    fn = CASES[case]
    try:
        ref = fn(jsp, jm, jnp.asarray)
    except Exception as exc:  # the port must raise where the reference does
        with pytest.raises(Exception):
            fn(tsp, tm, lambda a: torch.from_numpy(np.asarray(a)))
        assert case.endswith("_raises"), f"reference raised {exc!r}"
        return
    assert not case.endswith("_raises"), "the reference did not raise"
    got = fn(tsp, tm, lambda a: torch.from_numpy(np.asarray(a)))
    _compare(got, ref)


def test_padded_adj_keeps_padding_and_plans():
    src, dst, n, e = _padded_graph_arrays()
    tg = dt.graph((src, dst), num_nodes=n, num_edges=e, device="cpu")
    jg = dgl_tpu.graph((src, dst), num_nodes=n, num_edges=e)
    A, J = tg.adj(), jg.adj()
    assert A._rel is tg._relation()
    assert A.nnz == e and A.val.shape[0] == src.shape[0]
    np.testing.assert_array_equal(_np(A.val), np.asarray(J.val))
    np.testing.assert_array_equal(_np(A.row), np.asarray(J.row))
    w = _dense(22, src.shape[0])
    tg.edata["w"] = torch.from_numpy(w)
    jg.edata["w"] = jnp.asarray(w)
    _compare(tg.adj(eweight_name="w"), jg.adj(eweight_name="w"))
    _compare(tg.adjacency_matrix(transpose=True),
             jg.adjacency_matrix(transpose=True))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _grads(jfn, tfn, args, cot):
    """Each input's gradient of <f(args), cot> on both sides."""
    out, pull = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jg = pull(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    tout = tfn(*ts)
    np.testing.assert_allclose(_np(tout), np.asarray(out), **TOL)
    tg = torch.autograd.grad(tout, ts, torch.from_numpy(cot),
                             allow_unused=True)
    for t, g, r in zip(ts, tg, jg):  # an unused input: a zero gradient
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(_np(g), np.asarray(r), **TOL)


def _pattern():
    ra, ca = _edges(0, N, M, 12)
    return ra, ca


GRAD_CASES = {
    "spmm": (lambda sp, A, x: sp.spmm(A, x), (), (M, 4)),
    "bspmm": (lambda sp, A, x: sp.bspmm(A, x), (H,), (M, 2, H)),
    "sddmm": (lambda sp, A, x, y: sp.sddmm(A, x, y).val, (), (N, 4), (4, M)),
    "bsddmm": (lambda sp, A, x, y: sp.bsddmm(A, x, y).val, (H,), (N, 4, H),
               (4, M, H)),
    "softmax_dim1": (lambda sp, A: sp.softmax(A, 1).val, (H,)),
    "softmax_dim0": (lambda sp, A: sp.softmax(A, 0).val, ()),
    "to_dense": (lambda sp, A: A.to_dense(), (H,)),
    "sp_mul_v": (lambda sp, A, v: sp.sp_mul_v(A, v).val, (), (N,)),
}
for _op in ("sum", "smax", "smin", "smean"):
    for _dim in (None, 0, 1):
        GRAD_CASES[f"{_op}_dim{_dim}"] = (
            lambda sp, A, op=_op, dim=_dim: getattr(sp, op)(A, dim), (H,))
GRAD_CASES["sprod_dimNone"] = (lambda sp, A: sp.sprod(A, None), ())


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_sparse_gradients_match(case):
    """The gradients of the values and of the dense operands. (The
    reference differentiates ``sprod`` along a dim only without duplicate
    segments, its scatter-multiply's rule, so only ``dim=None`` is held.)"""
    fn, vshape, *shapes = GRAD_CASES[case]
    r, c = _pattern()
    val = _dense(30, r.shape[0], *vshape)
    dense = [_dense(31 + i, *s) for i, s in enumerate(shapes)]

    def jfn(v, *xs):
        return fn(jsp, jsp.from_coo(jnp.asarray(r), jnp.asarray(c), v,
                                    (N, M)), *xs)

    def tfn(v, *xs):
        return fn(tsp, tsp.from_coo(r, c, v, (N, M)), *xs)

    out_shape = np.shape(jfn(jnp.asarray(val), *map(jnp.asarray, dense)))
    cot = _dense(40, *out_shape)
    _grads(jfn, tfn, [val] + dense, cot)


# ---------------------------------------------------------------------------
# DGL's sparse-API GCN (examples/sparse/gcn.py), end to end
# ---------------------------------------------------------------------------

GCN_DIMS = (12, 16, 16, 5)


def _gcn_graph(n=60, e=240, seed=3):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return src, dst, n


def _sparse_gcn(sp, g, act):
    """The example's matrix: D^-1/2 (A + I) D^-1/2, built as it builds
    it (a host merge of patterns and two host spspmm)."""
    A = g.adj()
    A_hat = A + sp.identity(A.shape, **_cpu(sp))
    D = sp.diag(A_hat.sum(0) ** -0.5)
    return D @ A_hat @ D


def _gcn_forward(A_norm, x, params, relu):
    h = x
    for i, (w, b) in enumerate(params):
        h = A_norm @ (h @ w) + b
        if i != len(params) - 1:
            h = relu(h)
    return h


def _gcn_params(seed=4):
    rng = np.random.default_rng(seed)
    return [((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
             (rng.normal(size=(b,)) * 0.1).astype(np.float32))
            for a, b in zip(GCN_DIMS[:-1], GCN_DIMS[1:])]


def test_sparse_gcn_matches_reference_and_graphconv():
    src, dst, n = _gcn_graph()
    jg = dgl_tpu.to_bidirected(dgl_tpu.remove_self_loop(
        dgl_tpu.graph((src, dst), num_nodes=n)))
    tg = dt.to_bidirected(dt.remove_self_loop(
        dt.graph((src, dst), num_nodes=n, device="cpu")))
    jA, tA = _sparse_gcn(jsp, jg, None), _sparse_gcn(tsp, tg, None)
    _compare(tA, jA)
    x = _dense(5, n, GCN_DIMS[0])
    params = _gcn_params()
    cot = _dense(6, n, GCN_DIMS[-1])

    def jloss(ps):
        return jnp.sum(_gcn_forward(jA, jnp.asarray(x), ps, jax.nn.relu)
                       * cot)

    jps = [(jnp.asarray(w), jnp.asarray(b)) for w, b in params]
    jout = _gcn_forward(jA, jnp.asarray(x), jps, jax.nn.relu)
    jgrads = jax.grad(jloss)(jps)
    tps = [(torch.from_numpy(w).requires_grad_(),
            torch.from_numpy(b).requires_grad_()) for w, b in params]
    tout = _gcn_forward(tA, torch.from_numpy(x), tps, torch.relu)
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    for (tw, tb), (jw, jb) in zip(tps, jgrads):
        np.testing.assert_allclose(_np(tw.grad), np.asarray(jw), **TOL)
        np.testing.assert_allclose(_np(tb.grad), np.asarray(jb), **TOL)

    # the same function as GraphConv(norm="both") on the graph plus
    # self-loops (symmetric, no multi-edges: every entry of A + I is 1)
    from dgl_tpu_torch.nn import GraphConv

    gl = dt.add_self_loop(tg)
    convs = [GraphConv(a, b, device="cpu")
             for a, b in zip(GCN_DIMS[:-1], GCN_DIMS[1:])]
    with torch.no_grad():
        for conv, (w, b) in zip(convs, params):
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(b))
    h = torch.from_numpy(x)
    for i, conv in enumerate(convs):
        h = conv(gl, h)
        if i != len(convs) - 1:
            h = torch.relu(h)
    (h * torch.from_numpy(cot)).sum().backward()
    scale = np.abs(_np(h)).max()
    np.testing.assert_allclose(_np(tout), _np(h), rtol=1e-4,
                               atol=1e-4 * scale)
    for conv, (tw, tb) in zip(convs, tps):
        for got, ref in ((tw.grad, conv.weight.grad), (tb.grad,
                                                      conv.bias.grad)):
            s = np.abs(_np(ref)).max()
            np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-4,
                                       atol=1e-4 * s)
