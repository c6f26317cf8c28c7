"""The bitmap SpMM's input on the card, the relation's CSC and CSR, on the
CPU.

Kernel B2 (``dgl_tpu_torch/csrc/bitmap_spmm.cu``, and its f32
instantiation B2f) walks each destination's in-edge list from
``Relation.csc_indptr`` / ``csc_indices`` forward and each source's
out-edge list from ``csr_indptr`` / ``csr_indices`` backward; its plain
version, which the CPU runs, reads the plan's bits (``bits_rev``, or
``bits`` when the relation is symmetric, backward). These tests show that
the index names exactly the pairs of the bits on a padded bipartite
relation with sink edges and rows without an in-edge, that ``gspmm`` hands
the relation to ``bitmap_copy_u_sum`` and its autograd function hands the
wrapper the relation's own arrays (no copies), that the forward and
backward with the relation still match ``dgl_tpu``'s ``_bitmap_matmul_xla``
/ ``_bitmap_bwd`` (rtol = atol = 1e-5, ``test_torch_bitmap_spmm.py``'s
bound), and that the argument checks refuse what the kernel does not take.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import bitmap_spmm as jb
import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.graph import Graph, Relation
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops import bitmap_spmm as tb

from test_torch_bitmap_spmm import _simple_edges
from test_torch_training import _vjp

N_SRC, N_DST, N_SINK = 5000, 700, 37


def _pairs(indptr, indices, n_rows):
    """The (row, id) pairs that ``indptr`` / ``indices`` name over their
    first ``n_rows`` rows."""
    ptr = indptr.tolist()
    idx = indices.tolist()
    return {(r, idx[k]) for r in range(n_rows)
            for k in range(ptr[r], ptr[r + 1])}


def _bits_pairs(bits, n_rows, n_cols):
    r, c = np.nonzero(tb.unpack_host(bits.numpy())[:n_rows, :n_cols])
    return set(zip(r.tolist(), c.tolist()))


def _bipartite():
    """Real edges of a bipartite relation, N_SRC x N_DST, dst rows 300..349
    without an in-edge, and N_SINK padded edges at the sink rows."""
    src, dst = _simple_edges(N_SRC, N_DST, 40000, 4)
    keep = (dst < 300) | (dst >= 350)
    return src[keep], dst[keep]


def _padded_rel(src, dst):
    src = np.concatenate([src, np.full(N_SINK, N_SRC)])
    dst = np.concatenate([dst, np.full(N_SINK, N_DST)])
    return Relation.from_coo(src, dst, N_SRC, N_DST, device="cpu",
                             num_edges=src.size - N_SINK)


@pytest.fixture(scope="module")
def padded():
    src, dst = _bipartite()
    rel = _padded_rel(src, dst)
    rel = rel.with_bitmap_plan(tb.build_bitmap_plan(rel))
    g = Graph({("u", "e", "v"): rel}, {"u": N_SRC, "v": N_DST})
    return src, dst, rel, g


def test_index_names_the_bits(padded):
    """The CSC's (d, s) rows name the pairs of ``bits``, the CSR's (s, d)
    rows those of ``bits_rev``; the sink edges lie past both ``indptr``s'
    last row, and the empty dst rows have no in-edge."""
    src, dst, rel, _ = padded
    plan = rel.bitmap_plan
    assert plan.bits_rev is not None
    assert rel.num_edges == src.size and rel.num_edges_padded == (
        src.size + N_SINK)
    want = set(zip(dst.tolist(), src.tolist()))
    assert _bits_pairs(plan.bits, N_DST, N_SRC) == want
    assert _pairs(rel.csc_indptr, rel.csc_indices, N_DST) == want
    got_t = _pairs(rel.csr_indptr, rel.csr_indices, N_SRC)
    assert _bits_pairs(plan.bits_rev, N_SRC, N_DST) == got_t
    assert {(d, s) for s, d in got_t} == want
    for ptr, idx, n_rows in ((rel.csc_indptr, rel.csc_indices, N_DST),
                             (rel.csr_indptr, rel.csr_indices, N_SRC)):
        assert ptr.dtype == idx.dtype == torch.int32
        assert ptr.numel() == n_rows + 1 and int(ptr[-1]) == rel.num_edges
        assert idx.numel() == rel.num_edges_padded
    deg = rel.csc_indptr[1:] - rel.csc_indptr[:-1]
    assert not deg[300:350].any() and bool(deg[:300].all())


def _record(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: (
        calls.append((a, k)), orig(*a, **k))[1])
    return calls


@pytest.mark.parametrize("op", ["copy_u_sum", "copy_u_mean"])
def test_gspmm_hands_the_relation(padded, monkeypatch, op):
    """``ops.gspmm``'s bitmap branch hands ``bitmap_copy_u_sum`` its
    relation, and the autograd function hands ``bitmap_matmul`` the
    relation's own CSC forward (``num_dst`` rows of ``bits``) and its own
    CSR backward (``num_src`` rows of ``bits_rev``), as keyword arguments."""
    _, _, rel, g = padded
    plan = rel.bitmap_plan
    outer = _record(monkeypatch, tb, "bitmap_copy_u_sum")
    calls = _record(monkeypatch, tb, "bitmap_matmul")
    x = torch.randn(N_SRC, 16, requires_grad=True)
    _kernels.reset_launch_counts()
    getattr(dt.ops, op)(g, x).square().sum().backward()
    assert not any(_kernels.launch_counts.values())  # CPU: plain version
    assert len(outer) == 1 and outer[0][0][0] is plan
    assert outer[0][0][2] is rel
    assert len(calls) == 2
    (fa, fk), (ba, bk) = calls
    assert fa[0] is plan.bits and fa[2] == N_DST
    assert fk["indptr"] is rel.csc_indptr
    assert fk["indices"] is rel.csc_indices
    assert ba[0] is plan.bits_rev and ba[2] == N_SRC
    assert bk["indptr"] is rel.csr_indptr
    assert bk["indices"] is rel.csr_indices


def _reference_pair(src, dst, n_src, n_dst, compute_dtype):
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    return jb.build_bitmap_plan(jrel, compute_dtype=compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("which", ["padded bipartite", "symmetric"])
def test_forward_and_backward_match_reference(which, compute_dtype):
    """With the relation passed, the forward and the gradient equal
    ``dgl_tpu``'s (``_bitmap_matmul_xla`` over ``bits``, ``_bitmap_bwd``
    over the transpose) at rtol = atol = 1e-5: the same rounding of the
    rows (bf16 or none) and f32 sums in another order."""
    if which == "symmetric":
        n_src = n_dst = 1500
        src, dst = _simple_edges(n_src, n_dst, 20000, 5, symmetric=True)
        rel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    else:
        n_src, n_dst = N_SRC, N_DST
        src, dst = _bipartite()
        rel = _padded_rel(src, dst)
    tp = tb.build_bitmap_plan(rel, compute_dtype=compute_dtype)
    assert (tp.bits_rev is None) == (which == "symmetric")
    jp = _reference_pair(src, dst, n_src, n_dst, compute_dtype)
    np.testing.assert_array_equal(np.asarray(jp.bits), tp.bits.numpy())
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n_src, 24)).astype(np.float32)
    cot = rng.normal(size=(n_dst, 24)).astype(np.float32)
    ref = np.asarray(jb.bitmap_copy_u_sum(jp, jnp.asarray(x)))
    ref_grad = _vjp(lambda u: jb.bitmap_copy_u_sum(jp, u), (x,), cot)[0]
    xt = torch.from_numpy(x).requires_grad_()
    out = tb.bitmap_copy_u_sum(tp, xt, rel)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-5)


def test_argument_checks(padded):
    """A CPU call runs the plain version with or without the index; with
    one, it must be 1-D int32 on x's device (int64 refused, not
    converted), ``indptr`` of ``n_rows + 1`` entries; the plan must be the
    relation's."""
    _, _, rel, _ = padded
    plan = rel.bitmap_plan
    x = torch.randn(N_SRC, 8)
    idx = {"indptr": rel.csc_indptr, "indices": rel.csc_indices}
    want = tb.bitmap_matmul(plan.bits, x, N_DST)
    torch.testing.assert_close(tb.bitmap_matmul(plan.bits, x, N_DST, **idx),
                               want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="indices must be"):
        tb.bitmap_matmul(plan.bits, x, N_DST, indptr=rel.csc_indptr,
                         indices=rel.csc_indices.long())
    with pytest.raises(ValueError, match="indptr must be"):
        tb.bitmap_matmul(plan.bits, x, N_DST,
                         indptr=rel.csc_indptr.long(),
                         indices=rel.csc_indices)
    with pytest.raises(ValueError, match="indptr must be"):
        tb.bitmap_matmul(plan.bits, x, N_DST, indices=rel.csc_indices)
    with pytest.raises(ValueError, match="entries"):
        tb.bitmap_matmul(plan.bits, x, N_DST - 1, **idx)
    with pytest.raises(ValueError, match="indices must be"):
        tb.bitmap_matmul(plan.bits, x, N_DST, indptr=rel.csc_indptr,
                         indices=rel.csc_indices.to("meta"))
    with pytest.raises(ValueError, match="2-D"):
        tb.bitmap_matmul(plan.bits, x[:, 0], N_DST)
    # the CPU reads the bits: without them it refuses, index or not
    with pytest.raises(ValueError, match="bits must be"):
        tb.bitmap_matmul(None, x, N_DST, **idx)
    with pytest.raises(ValueError, match="does not fit"):
        tb.bitmap_matmul(plan.bits[:, :512], x, N_DST)
    # the plan must be the relation's: another relation's counts or edges
    other = Relation.from_coo(*_simple_edges(N_SRC, N_DST, 30000, 9),
                              N_SRC, N_DST, device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        tb.bitmap_copy_u_sum(plan, x, other)
    # B3-B5 share the check
    assert tbg._check_plan_rel is tb._check_plan_rel


@pytest.mark.parametrize("idtype", [torch.int32, torch.int64])
def test_bitmap_plan_only_on_int32_relations(idtype):
    """``with_spmm_plans`` attaches a bitmap plan only to a relation whose
    index is int32, the kernels' input: an int64 graph keeps its hub plan,
    and ``copy_u_sum`` over it still equals the int32 graph's exact sum
    within the hub plan's bf16 rounding."""
    n = 1500
    src, dst = _simple_edges(n, n, 20000, 5, symmetric=True)
    g = dt.graph((src, dst), num_nodes=n, idtype=idtype, device="cpu")
    gp = g.with_spmm_plans(num_hubs=64, bitmap=True)
    rel = gp._relation()
    assert rel.csc_indices.dtype == idtype
    assert (rel.bitmap_plan is not None) == (idtype == torch.int32)
    assert rel.hub_plan is not None
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(n, 16)).astype(np.float32))
    want = dt.ops.copy_u_sum(g, x)
    got = dt.ops.copy_u_sum(gp, x)
    torch.testing.assert_close(got, want, rtol=2e-2,
                               atol=2e-2 * want.abs().max().item())
