"""The bitmap GAT backward's second input, the relation's CSC and CSR, on
the CPU.

Kernel B4 (``dgl_tpu_torch/csrc/bitmap_gat_bwd_dst.cu``) walks each
destination's in-edge list from ``Relation.csc_indptr`` / ``csc_indices``,
and kernel B5 (``bitmap_gat_bwd_src.cu``) each source's out-edge list from
``csr_indptr`` / ``csr_indices``; their plain versions, which the CPU runs
and which are held against ``dgl_tpu``'s ``_gat_xla_bwd``, read the plan's
bits (B5 the transpose, ``bits_rev``, or ``bits`` when the relation is
symmetric). These tests show that ``_BitmapGAT.backward`` hands each
wrapper the relation's own arrays, that they name the pairs of the bits the
plain version reads on the plan graphs of ``test_torch_gat_csc.py``, that
the gradients with the relation still match ``dgl_tpu`` (rtol = atol =
1e-4 on a cotangent of bf16 values, ``test_torch_training.py``'s bound),
and that the argument checks refuse what the kernels do not take.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.bitmap_gat as jbg
from dgl_tpu.ops.bitmap_spmm import build_bitmap_plan as j_build_bitmap_plan
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.graph import Graph, Relation
from dgl_tpu_torch.nn import GATConv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops.bitmap_spmm import _expand_bits, build_bitmap_plan

from test_torch_gat_csc import _asym_edges, _pairs_of_csc
from test_torch_gcn_gat import _dense_graph
from test_torch_training import _bf16_values


@pytest.fixture(scope="module")
def dense():
    return _dense_graph()


def _pairs_of_bits_t(plan):
    """The (d, s) pairs that B5's plain version reads: the transpose
    bitmap's (s, d) bits."""
    bits_t = plan.bits if plan.bits_rev is None else plan.bits_rev
    cells = _expand_bits(bits_t[:plan.num_src])[:, :plan.num_dst]
    s, d = torch.nonzero(cells, as_tuple=True)
    return set(zip(d.tolist(), s.tolist()))


def _plan_graph(which, dense):
    if which == "dense":
        return dense[1]
    # the port's Graph is homogeneous: 700 x 700, 50 empty dst rows
    src, dst, n, _ = _asym_edges(n_dst=700)
    kw = {}
    if which == "padded":
        src = np.concatenate([src, np.full(37, n)])
        dst = np.concatenate([dst, np.full(37, n)])
        kw = {"num_edges": src.size - 37}
    rel = Relation.from_coo(src, dst, n, n, device="cpu", **kw)
    return Graph({("_N", "_E", "_N"): rel.with_bitmap_plan(
        build_bitmap_plan(rel))}, {"_N": n})


def _record(monkeypatch, names):
    calls = {}
    for name in names:
        orig = getattr(tbg, name)
        monkeypatch.setattr(tbg, name, lambda *a, _f=orig, _n=name, **k: (
            calls.setdefault(_n, []).append(a), _f(*a, **k))[1])
    return calls


@pytest.mark.parametrize("which", ["dense", "asymmetric", "padded"])
def test_index_handed_to_kernels_names_the_bits(dense, monkeypatch, which):
    """Through ``GATConv``'s bitmap route, forward and backward: B4's
    wrapper gets the relation's own CSC tensors and B5's its own CSR tensors
    (no copies), int32 with one entry a row more than the rows, and
    operands detached from the autograd graph; the CSC names the (d, s)
    pairs of ``bits``, the CSR those of the transpose bitmap that B5's
    plain version reads. "padded" carries 37 padded edges at the sink
    rows, past both ``indptr``s' last row."""
    g = _plan_graph(which, dense)
    rel = g._relation()
    plan = rel.bitmap_plan
    assert (plan.bits_rev is None) == (which == "dense")
    calls = _record(monkeypatch, ("bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"))
    conv = GATConv(6, 4, 2, allow_zero_in_degree=True,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(g.num_nodes(), 6)).astype(np.float32)).requires_grad_()
    conv(g, x).square().sum().backward()
    assert sorted(calls) == ["bitmap_gat_bwd_dst", "bitmap_gat_bwd_src"]
    assert all(len(v) == 1 for v in calls.values())
    # the kernels' operands carry no autograd history
    assert not any(t.requires_grad for v in calls.values() for t in v[0]
                   if isinstance(t, torch.Tensor))
    (bits, indptr, indices), n_dst = calls["bitmap_gat_bwd_dst"][0][:3], \
        calls["bitmap_gat_bwd_dst"][0][10]
    assert bits is plan.bits and n_dst == rel.num_dst
    assert indptr is rel.csc_indptr and indices is rel.csc_indices
    (bits_t, t_indptr, t_indices), n_src = calls["bitmap_gat_bwd_src"][0][
        :3], calls["bitmap_gat_bwd_src"][0][10]
    assert bits_t is (plan.bits if plan.bits_rev is None else plan.bits_rev)
    assert n_src == rel.num_src
    assert t_indptr is rel.csr_indptr and t_indices is rel.csr_indices
    for ptr, idx, n_rows in ((indptr, indices, rel.num_dst),
                             (t_indptr, t_indices, rel.num_src)):
        assert ptr.dtype == idx.dtype == torch.int32
        assert ptr.numel() == n_rows + 1 and int(ptr[-1]) == rel.num_edges
    want_dst = set(zip(*[a.tolist() for a in torch.nonzero(
        _expand_bits(plan.bits[:rel.num_dst])[:, :rel.num_src],
        as_tuple=True)]))
    assert len(want_dst) == rel.num_edges
    assert _pairs_of_csc(indptr, indices, rel.num_dst) == want_dst
    # the CSR's (s, d) rows, turned to (d, s), name the transpose's pairs
    got_src = {(d, s) for s, d in _pairs_of_csc(t_indptr, t_indices,
                                               rel.num_src)}
    assert got_src == _pairs_of_bits_t(plan) == want_dst


def _case(symmetric, heads, odim, seed):
    rng = np.random.default_rng(seed)
    if symmetric:
        n = 650
        src = rng.integers(0, n, 8000)
        dst = rng.integers(0, n, 8000)
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        pair = np.unique(dst.astype(np.int64) * n + src)
        src, dst, n_src, n_dst = pair % n, pair // n, n, n
    else:
        src, dst, n_src, n_dst = _asym_edges(seed=seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_src, heads), (n_dst, heads),
                        (n_src, heads, odim))]
    cot = _bf16_values(rng.normal(size=(n_dst, heads, odim)))
    return src, dst, n_src, n_dst, arrays, cot


@pytest.mark.parametrize("symmetric,heads,odim", [
    (False, 3, 5), (False, 1, 41), (True, 4, 16)])
def test_grads_with_relation_match_reference(symmetric, heads, odim):
    """d el, d er, d h of ``bitmap_gat`` handed the relation against
    ``jax.vjp`` through the reference (its CPU path, ``_gat_xla_bwd``), at
    rtol = atol = 1e-4 on a cotangent of bf16 values; and equal to the call
    without the relation (both run the plain versions on the CPU, which
    launch nothing)."""
    src, dst, n_src, n_dst, arrays, cot = _case(symmetric, heads, odim,
                                               heads * 10 + odim)
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    jplan, tplan = j_build_bitmap_plan(jrel), build_bitmap_plan(trel)
    assert (tplan.bits_rev is None) == symmetric
    pull = jax.jit(lambda *a: jax.vjp(
        lambda x, y, z: jbg.bitmap_gat(0.2, jplan, x, y, z), *a)[1](
            jnp.asarray(cot)))
    ref = [np.asarray(g) for g in pull(*[jnp.asarray(a) for a in arrays])]
    grads = []
    _kernels.reset_launch_counts()
    for rel in (trel, None):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        (tbg.bitmap_gat(0.2, tplan, *ts, rel)
         * torch.from_numpy(cot)).sum().backward()
        grads.append([t.grad for t in ts])
    assert not any(_kernels.launch_counts.values())
    for name, g, g_none, r in zip(("el", "er", "h"), *grads, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        torch.testing.assert_close(g, g_none, rtol=0, atol=0)


def _bwd_args(kernel):
    """Good arguments of ``_check_bwd`` for B4 (``"dst"``) or B5
    (``"src"``) on the asymmetric plan graph (700 sources, 600
    destinations)."""
    src, dst, n_src, n_dst = _asym_edges()
    rel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    plan = build_bitmap_plan(rel)
    heads, odim = 2, 3
    if kernel == "dst":
        index, bits, n_rows, n_cols = "CSC", plan.bits, n_dst, n_src
        indptr, indices = rel.csc_indptr, rel.csc_indices
    else:
        index, bits, n_rows, n_cols = "CSR", plan.bits_rev, n_src, n_dst
        indptr, indices = rel.csr_indptr, rel.csr_indices
    ops = tuple((name, torch.ones(n_dst, heads), n_dst)
                for name in ("er", "lse", "c"))
    return dict(index=index, bits=bits, indptr=indptr, indices=indices,
                el=torch.ones(n_src, heads),
                h=torch.ones(n_src, heads, odim, dtype=torch.bfloat16),
                dz=torch.ones(n_dst, heads, odim, dtype=torch.bfloat16),
                row_ops=ops, n_rows=n_rows, n_cols=n_cols)


_BAD = {
    "missing indices": (dict(indices=lambda a: None), "indices must be"),
    "missing indptr": (dict(indptr=lambda a: None), "indptr must be"),
    "int64 indices": (dict(indices=lambda a: a["indices"].long()),
                      "indices must be"),
    "int64 indptr": (dict(indptr=lambda a: a["indptr"].long()),
                     "indptr must be"),
    "2-D indices": (dict(indices=lambda a: a["indices"][None]),
                    "indices must be"),
    "indices on another device": (
        dict(indices=lambda a: a["indices"].to("meta")), "indices must be"),
    "indptr on another device": (
        dict(indptr=lambda a: a["indptr"].to("meta")), "indptr must be"),
    "indptr short": (dict(indptr=lambda a: a["indptr"][:-1]), "entries"),
    "indptr for fewer rows": (dict(n_rows=lambda a: a["n_rows"] - 1),
                              "entries"),
    "f32 h": (dict(h=lambda a: a["h"].float()), "bf16"),
    "f32 dz": (dict(dz=lambda a: a["dz"].float()), "dz must be"),
    "dz of other heads": (dict(dz=lambda a: a["dz"][:, :1]), "dz must be"),
    "el of other heads": (dict(el=lambda a: a["el"][:, :1]), "el must be"),
    "f64 el": (dict(el=lambda a: a["el"].double()), "el must be"),
    "lse too short": (dict(row_ops=lambda a: tuple(
        (n, t[:5] if n == "lse" else t, r) for n, t, r in a["row_ops"])),
        "lse must be"),
    "bits not uint8": (dict(bits=lambda a: a["bits"].to(torch.int32)),
                       "uint8"),
    "bits too narrow": (dict(bits=lambda a: a["bits"][:, :0]),
                        "does not fit"),
    "h on another device": (dict(h=lambda a: a["h"].to("meta")),
                            "unsupported device"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
@pytest.mark.parametrize("kernel", ["dst", "src"])
def test_check_bwd_raises(kernel, case):
    """Each bad input raises ``ValueError`` from ``_check_bwd`` and from the
    wrapper, on the CPU as on the card; the message names the relation's
    index the kernel walks."""
    args = _bwd_args(kernel)
    edits, match = _BAD[case]
    for k, f in edits.items():
        args[k] = f(args)
    with pytest.raises(ValueError, match=match) as err:
        tbg._check_bwd(**args)
    if match.endswith("must be") and case.startswith(("missing", "int64")):
        assert f"the relation's {args['index']}" in str(err.value)
    ops = {name: t for name, t, _ in args["row_ops"]}
    call = (tbg.bitmap_gat_bwd_dst if kernel == "dst"
            else tbg.bitmap_gat_bwd_src)
    with pytest.raises(ValueError, match=match):
        call(args["bits"], args["indptr"], args["indices"], args["el"],
             ops["er"], args["h"], 0.2, ops["lse"], ops["c"], args["dz"],
             args["n_rows"])


@pytest.mark.parametrize("kernel", ["dst", "src"])
def test_check_bwd_passes_good_inputs(kernel):
    """The good inputs pass, and on the CPU the index may be None: the
    plain version reads the bits, with the same result."""
    args = _bwd_args(kernel)
    tbg._check_bwd(**args)
    tbg._check_bwd(**{**args, "indptr": None, "indices": None})
    rng = np.random.default_rng(5)
    ops = {name: torch.from_numpy(rng.normal(size=t.shape).astype(
        np.float32)) for name, t, _ in args["row_ops"]}
    el = torch.from_numpy(rng.normal(size=args["el"].shape).astype(
        np.float32))
    h = torch.from_numpy(rng.normal(size=args["h"].shape).astype(
        np.float32)).to(torch.bfloat16)
    dz = torch.from_numpy(rng.normal(size=args["dz"].shape).astype(
        np.float32)).to(torch.bfloat16)
    call = (tbg.bitmap_gat_bwd_dst if kernel == "dst"
            else tbg.bitmap_gat_bwd_src)
    got = [call(args["bits"], ptr, idx, el, ops["er"], h, 0.2, ops["lse"],
                ops["c"], dz, args["n_rows"])
           for ptr, idx in ((args["indptr"], args["indices"]), (None, None))]
    for a, b in zip(*[g if isinstance(g, tuple) else (g,) for g in got]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_passes_nh():
    """B5's passes of fewer heads (``nh``, which only its private launcher
    takes): H = 8, O = 8 as two passes of 4 heads; an nh that does not fit
    a pass is refused."""
    assert tbg._passes(8, 8) == (8, 8, 8, 8)
    assert tbg._passes(8, 8, nh=4) == (4, 8, 8, 8)
    assert tbg._passes(3, 5, nh=2) == (2, 8, 4, 8)
    for nh, nf in ((3, None), (2, 64), (16, 8)):
        with pytest.raises(ValueError, match="nh must be"):
            tbg._passes(1, 41, nf, nh)


def test_occupancy_keys_name_gather_bytes(monkeypatch):
    """``bwd_occupancy`` reports gather bytes in flight (no bitmap is read
    any more), for B5's passes of ``nh`` heads too."""
    seen = []

    class Lib:
        def __getattr__(self, name):
            def fn(nh, nf, addr):
                seen.append((name, nh, nf))
                return 0
            return fn

    monkeypatch.setattr(_kernels, "library", lambda: Lib())
    got = tbg.bwd_occupancy("bitmap_gat_bwd_src", 8, 8, nh=4)
    assert seen == [("dgl_bitmap_gat_bwd_src_occupancy", 4, 8)]
    assert got["nh"] == 4 and "gather_bytes_in_flight_per_sm" in got
    assert not any("bitmap" in k for k in got)
