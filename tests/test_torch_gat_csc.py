"""The bitmap GAT forward's second input, the relation's CSC, and the
layers' zero-in-degree check, on the CPU.

Kernel B3 (``dgl_tpu_torch/csrc/bitmap_gat_fwd.cu``) walks each
destination's in-edge list from ``Relation.csc_indptr`` / ``csc_indices``;
its plain version, which the CPU runs and which is held against
``dgl_tpu``'s ``_gat_xla``, reads the plan's bits. These tests show that the
two name the same (d, s) pairs on the plan graphs of
``test_torch_gcn_gat.py``, that ``bitmap_gat`` with the relation still
matches ``dgl_tpu`` (rtol = atol = 1e-4, that file's bound for ``out``), and
that the argument checks refuse what the kernel does not take.

``GraphConv`` and ``GATConv`` check for zero-in-degree nodes against the
minimum in-degree that ``Relation.from_coo`` counts on the host, so a layer
call reads no degree back from the device.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dgl_tpu
import dgl_tpu.ops.bitmap_gat as jbg
from dgl_tpu.ops.bitmap_spmm import build_bitmap_plan as j_build_bitmap_plan
import dgl_tpu_torch as dt
from dgl_tpu_torch.base import DGLError
from dgl_tpu_torch.graph import Graph, Relation
from dgl_tpu_torch.nn import GATConv, GraphConv
from dgl_tpu_torch.ops import bitmap_gat as tbg
from dgl_tpu_torch.ops.bitmap_spmm import _expand_bits, build_bitmap_plan

from test_torch_gcn_gat import _dense_graph


def _asym_edges(n_src=700, n_dst=600, e=9000, seed=1):
    """The recipe of ``test_bitmap_gat_matches``: the last 50 destinations
    have no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - 50, e)
    pair = np.unique(dst.astype(np.int64) * n_src + src)
    return pair % n_src, pair // n_src, n_src, n_dst


@pytest.fixture(scope="module")
def dense():
    return _dense_graph()


def _pairs_of_bits(plan):
    cells = _expand_bits(plan.bits[:plan.num_dst])[:, :plan.num_src]
    d, s = torch.nonzero(cells, as_tuple=True)
    return set(zip(d.tolist(), s.tolist()))


def _pairs_of_csc(indptr, indices, n_rows):
    deg = (indptr[1:] - indptr[:-1]).long()
    d = torch.repeat_interleave(torch.arange(n_rows), deg)
    return set(zip(d.tolist(), indices[:int(indptr[-1])].tolist()))


def _record_fwd(monkeypatch):
    calls = []
    orig = tbg.bitmap_gat_fwd
    monkeypatch.setattr(tbg, "bitmap_gat_fwd", lambda *a, **k: (
        calls.append(a), orig(*a, **k))[1])
    return calls


@pytest.mark.parametrize("which", ["dense", "asymmetric", "padded"])
def test_csc_handed_to_kernel_names_the_bits(dense, monkeypatch, which):
    """Through ``GATConv``'s bitmap route, the wrapper gets the relation's
    own CSC tensors (no copy), and they name the (d, s) pairs the plan's
    bits name. "padded" carries 37 padded edges at the sink rows, which lie
    past ``indptr[num_dst]`` and so in no row."""
    if which == "dense":
        g = dense[1]
    else:  # the port's Graph is homogeneous: 700 x 700, 50 empty rows
        src, dst, n, _ = _asym_edges(n_dst=700)
        kw = {}
        if which == "padded":
            src = np.concatenate([src, np.full(37, n)])
            dst = np.concatenate([dst, np.full(37, n)])
            kw = {"num_edges": src.size - 37}
        rel = Relation.from_coo(src, dst, n, n, device="cpu", **kw)
        g = Graph({("_N", "_E", "_N"): rel.with_bitmap_plan(
            build_bitmap_plan(rel))}, {"_N": n})
    rel = g._relation()
    assert (rel.bitmap_plan.bits_rev is None) == (which == "dense")
    calls = _record_fwd(monkeypatch)
    conv = GATConv(6, 4, 2, allow_zero_in_degree=True,
                   generator=torch.Generator().manual_seed(0),
                   device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(g.num_nodes(), 6)).astype(np.float32))
    with torch.no_grad():
        conv(g, x)
    assert len(calls) == 1
    bits, indptr, indices = calls[0][:3]
    assert indptr is rel.csc_indptr and indices is rel.csc_indices
    assert bits is rel.bitmap_plan.bits
    assert indptr.dtype == indices.dtype == torch.int32
    assert indptr.numel() == rel.num_dst + 1
    assert int(indptr[-1]) == rel.num_edges
    want = _pairs_of_bits(rel.bitmap_plan)
    assert len(want) == rel.num_edges
    assert _pairs_of_csc(indptr, indices, rel.num_dst) == want


@pytest.mark.parametrize("heads,odim", [(4, 16), (1, 41)])
def test_bitmap_gat_with_relation_matches_reference(heads, odim):
    """``bitmap_gat`` handed the relation (the CSC beside the plan) against
    the reference's ``_gat_xla`` path, and equal to the call without it."""
    src, dst, n_src, n_dst = _asym_edges(seed=heads)
    jrel = dgl_tpu.heterograph({("u", "e", "v"): (src, dst)},
                               {"u": n_src, "v": n_dst})._relation(None)
    trel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    jplan, tplan = j_build_bitmap_plan(jrel), build_bitmap_plan(trel)
    rng = np.random.default_rng(heads + 10)
    el = rng.normal(size=(n_src, heads)).astype(np.float32)
    er = rng.normal(size=(n_dst, heads)).astype(np.float32)
    h = rng.normal(size=(n_src, heads, odim)).astype(np.float32)
    jout, _ = jbg._fwd_impl(0.2, jplan, jnp.asarray(el), jnp.asarray(er),
                            jnp.asarray(h))
    args = (torch.from_numpy(el), torch.from_numpy(er), torch.from_numpy(h))
    out = tbg.bitmap_gat(0.2, tplan, *args, trel)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out, tbg.bitmap_gat(0.2, tplan, *args),
                               rtol=0, atol=0)


def test_bitmap_gat_refuses_another_relation():
    """The plan and the relation must agree on num_src, num_dst and the
    edge count; an int64 relation is refused, not converted."""
    src, dst, n_src, n_dst = _asym_edges()
    rel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    plan = build_bitmap_plan(rel)
    assert plan.num_edges == rel.num_edges
    el, er = torch.ones(n_src, 2), torch.ones(n_dst, 2)
    h = torch.ones(n_src, 2, 3)
    fewer = Relation.from_coo(src[1:], dst[1:], n_src, n_dst, device="cpu")
    with pytest.raises(ValueError, match="num_edges"):
        tbg.bitmap_gat(0.2, plan, el, er, h, fewer)
    other = Relation.from_coo(src, dst, n_src, n_dst + 1, device="cpu")
    with pytest.raises(ValueError, match="num_dst"):
        tbg.bitmap_gat(0.2, plan, el, er, h, other)
    wide = Relation.from_coo(src, dst, n_src + 1, n_dst, device="cpu")
    with pytest.raises(ValueError, match="num_src"):
        tbg.bitmap_gat(0.2, plan, el, er, h, wide)
    as64 = Relation.from_coo(src, dst, n_src, n_dst, device="cpu",
                             idtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        tbg.bitmap_gat(0.2, plan, el, er, h, as64)
    # the moved plan keeps its edge count
    assert plan.to("cpu").num_edges == rel.num_edges


def test_plan_and_relation_tied_by_edge_set():
    """A relation with the plan's counts but other edges is refused: the
    reverse of a square asymmetric relation, by ``bitmap_gat`` and by
    ``with_bitmap_plan``. The edge hash ignores edge order, id type and
    padding, and moved plans and relations keep it."""
    src, dst, n, _ = _asym_edges(n_dst=700)
    rel = Relation.from_coo(src, dst, n, n, device="cpu")
    plan = build_bitmap_plan(rel)
    assert plan.bits_rev is not None and plan.edge_hash == rel.edge_hash()
    rev = rel.reverse()
    assert (rev.num_src, rev.num_dst, rev.num_edges) == (
        plan.num_src, plan.num_dst, plan.num_edges)
    assert rev.edge_hash() != plan.edge_hash
    el, er, h = torch.ones(n, 2), torch.ones(n, 2), torch.ones(n, 2, 3)
    with pytest.raises(ValueError, match="edge sets"):
        tbg.bitmap_gat(0.2, plan, el, er, h, rev)
    with pytest.raises(DGLError, match="edge sets differ"):
        rev.with_bitmap_plan(plan)
    order = np.random.default_rng(4).permutation(src.size)
    pad = np.full(5, n)
    same = Relation.from_coo(np.concatenate([src[order], pad]),
                             np.concatenate([dst[order], pad]), n, n,
                             num_edges=src.size, device="cpu")
    assert same.edge_hash() == plan.edge_hash
    assert Relation.from_coo(src, dst, n, n, idtype=torch.int64,
                             device="cpu").edge_hash() == plan.edge_hash
    assert same.with_bitmap_plan(plan).to("cpu").edge_hash() == (
        plan.to("cpu").edge_hash)
    assert tbg.bitmap_gat(0.2, plan, el, er, h, same).shape == (n, 2, 3)


def _fwd_args():
    src, dst, n_src, n_dst = _asym_edges()
    rel = Relation.from_coo(src, dst, n_src, n_dst, device="cpu")
    plan = build_bitmap_plan(rel)
    return dict(bits=plan.bits, indptr=rel.csc_indptr,
                indices=rel.csc_indices, el=torch.ones(n_src, 2),
                er=torch.ones(n_dst, 2),
                h=torch.ones(n_src, 2, 3, dtype=torch.bfloat16),
                n_rows=n_dst)


_BAD = {
    "int64 indices": (dict(indices=lambda a: a["indices"].long()),
                      "indices must be"),
    "int64 indptr": (dict(indptr=lambda a: a["indptr"].long()),
                     "indptr must be"),
    "2-D indices": (dict(indices=lambda a: a["indices"][None]),
                    "indices must be"),
    "indices on another device": (
        dict(indices=lambda a: a["indices"].to("meta")), "indices must be"),
    "only indptr": (dict(indices=lambda a: None), "indices must be"),
    "indptr short": (dict(indptr=lambda a: a["indptr"][:-1]), "entries"),
    "indptr for fewer rows": (dict(n_rows=lambda a: a["n_rows"] - 1),
                              "entries"),
    "f32 h": (dict(h=lambda a: a["h"].float()), "bf16"),
    "el of other heads": (dict(el=lambda a: a["el"][:, :1]), "el must be"),
    "er too short": (dict(er=lambda a: a["er"][:5]), "er "),
    "f64 el": (dict(el=lambda a: a["el"].double()), "el must be"),
    "bits not uint8": (dict(bits=lambda a: a["bits"].to(torch.int32)),
                       "uint8"),
    "bits too narrow": (dict(bits=lambda a: a["bits"][:, :0]),
                        "does not fit"),
    "h on another device": (dict(h=lambda a: a["h"].to("meta")),
                            "unsupported device"),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_check_fwd_raises(case):
    """Each bad input raises ``ValueError`` from ``_check_fwd``, on the CPU
    as on the card."""
    args = _fwd_args()
    edits, match = _BAD[case]
    for k, f in edits.items():
        args[k] = f(args)
    with pytest.raises(ValueError, match=match):
        tbg._check_fwd(**args)
    with pytest.raises(ValueError, match=match):
        tbg.bitmap_gat_fwd(args["bits"], args["indptr"], args["indices"],
                           args["el"], args["er"], args["h"], 0.2,
                           args["n_rows"])


def test_check_fwd_passes_good_inputs():
    """The good inputs pass, and on the CPU the CSC may be None: the plain
    version reads the bits, with the same result."""
    args = _fwd_args()
    tbg._check_fwd(**args)
    tbg._check_fwd(**{**args, "indptr": None, "indices": None})
    call = lambda a: tbg.bitmap_gat_fwd(  # noqa: E731
        a["bits"], a["indptr"], a["indices"], a["el"], a["er"], a["h"], 0.2,
        a["n_rows"])
    for got, want in zip(call(args), call({**args, "indptr": None,
                                           "indices": None})):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("heads,odim,nf,want", [
    (8, 8, None, (8, 8, 8, 8)),     # layer 0 of the Reddit GAT
    (1, 41, None, (1, 64, 1, 64)),  # layer 1: one pass
    (1, 41, 16, (1, 16, 1, 48)),    # layer 1 in three passes of 16
    (3, 5, None, (4, 8, 4, 8)),
    (2, 130, None, (1, 64, 2, 192)),
    (2, 130, 8, (2, 8, 2, 136)),
])
def test_passes(heads, odim, nf, want):
    """The kernels' passes: by default the fewest (one pass of nh heads x
    nf features holds nh * nf <= 64), or those of a given nf (which only
    B3's private launcher takes, for the card tests)."""
    assert tbg._passes(heads, odim, nf) == want
    with pytest.raises(ValueError, match="nf must be"):
        tbg._passes(1, 41, 12)


# ---------------------------------------------------------------------------
# the zero-in-degree check reads the relation's minimum in-degree
# ---------------------------------------------------------------------------


def _degree_graph(isolated: bool):
    """A simple graph on 30 nodes in which node 0 has no in-edge unless a
    self-loop is added."""
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 30, 200), rng.integers(1, 30, 200)
    if not isolated:
        src, dst = np.concatenate([src, [0]]), np.concatenate([dst, [0]])
    flat = np.unique(dst * 30 + src)
    return dt.graph((flat % 30, flat // 30), num_nodes=30, device="cpu")


def test_relation_counts_degree_extremes():
    """``from_coo`` counts the minima on the host beside the maxima; the
    reverse view swaps in and out; copies and moves carry them."""
    src = np.array([0, 0, 1, 2, 2, 2])
    dst = np.array([1, 2, 2, 0, 1, 3])
    rel = Relation.from_coo(src, dst, 4, 5, device="cpu")
    indeg = np.bincount(dst, minlength=5)
    outdeg = np.bincount(src, minlength=4)
    assert (rel.min_in_degree, rel.max_in_degree) == (0, indeg.max())
    assert (rel.min_out_degree, rel.max_out_degree) == (0, outdeg.max())
    full = Relation.from_coo(np.arange(4), np.arange(4), 4, 4, device="cpu")
    assert full.min_in_degree == full.min_out_degree == 1
    rev = rel.reverse()
    assert (rev.min_in_degree, rev.max_in_degree) == (0, outdeg.max())
    assert rev.max_out_degree == indeg.max()
    loops = Relation.from_coo([0, 1, 2, 3, 1], [0, 1, 2, 3, 2], 4, 4,
                              device="cpu")
    assert loops.reverse().min_in_degree == loops.min_out_degree == 1
    for r in (loops.to("cpu"), loops.with_hub_plan(None),
              loops.with_bitmap_plan(None)):
        assert (r.min_in_degree, r.min_out_degree) == (1, 1)
    empty = Relation.from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                              0, 0, device="cpu")
    assert empty.min_in_degree == empty.min_out_degree == 0
    padded = Relation.from_coo([0, 1, 2, 3], [1, 2, 0, 3], 3, 3,
                               num_edges=3, device="cpu")
    assert padded.min_in_degree == 1  # the padded edge is in no real row


def _never_read_degrees(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a layer read the in-degrees")

    monkeypatch.setattr(Relation, "in_degrees", refuse)
    monkeypatch.setattr(Graph, "in_degrees", refuse)


@pytest.mark.parametrize("layer", ["gat", "gat_bitmap", "gcn_none",
                                   "gcn_left"])
def test_layers_do_not_read_the_degrees(monkeypatch, layer):
    """No GATConv or GraphConv call reads the in-degrees (which would read
    them back from the card): the check uses the relation's minimum. (A
    GraphConv that normalises by the in-degree, "both" or "right", reads
    them on the device for that, and is not shown here.)"""
    g = _degree_graph(isolated=False)
    if layer == "gat_bitmap":
        g = g.with_spmm_plans(num_hubs=4, bitmap=True, dense_attn=False)
        assert g._relation().bitmap_plan is not None
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(30, 5)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    conv = (GATConv(5, 3, 2, generator=gen, device="cpu")
            if layer.startswith("gat") else
            GraphConv(5, 3, norm=layer[4:], generator=gen, device="cpu"))
    _never_read_degrees(monkeypatch)
    with torch.no_grad():
        out = conv.eval()(g, x)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("kind", ["gat", "gcn"])
@pytest.mark.parametrize("isolated", [True, False])
def test_zero_in_degree_unknown_minimum(kind, isolated):
    """A relation built by hand, without its degree extremes (-1), is still
    checked: the check reads its in-degrees then."""
    built = _degree_graph(isolated)._relation()
    rel = Relation({f: getattr(built, f) for f in Relation.ARRAY_FIELDS},
                   num_src=30, num_dst=30, num_edges=built.num_edges)
    assert rel.min_in_degree == -1
    g = Graph({("_N", "_E", "_N"): rel}, {"_N": 30})
    conv = (GATConv(5, 3, 2, device="cpu") if kind == "gat"
            else GraphConv(5, 3, device="cpu"))
    if isolated:
        with pytest.raises(DGLError, match="0-in-degree nodes"):
            conv(g, torch.ones(30, 5))
    else:
        assert torch.isfinite(conv(g, torch.ones(30, 5))).all()


@pytest.mark.parametrize("kind", ["gat", "gcn"])
def test_zero_in_degree_error_unchanged(kind):
    """The error still raises where a node has no in-edge, with the same
    text, and ``allow_zero_in_degree=True`` still lets the call run."""
    g = _degree_graph(isolated=True)
    assert g._relation().min_in_degree == 0
    x = torch.ones(30, 5)
    make = ((lambda allow: GATConv(5, 3, 2, allow_zero_in_degree=allow,
                                   device="cpu"))
            if kind == "gat" else
            (lambda allow: GraphConv(5, 3, allow_zero_in_degree=allow,
                                     device="cpu")))
    with pytest.raises(DGLError, match=(
            r"^There are 0-in-degree nodes in the graph; output for those "
            r"nodes will be invalid\. Add self-loops or pass "
            r"allow_zero_in_degree=True \(reference graphconv\.py:440 "
            r"check\)\.$")):
        make(False)(g, x)
    with torch.no_grad():
        assert torch.isfinite(make(True).eval()(g, x)).all()
    make(False)(_degree_graph(isolated=False), x)
