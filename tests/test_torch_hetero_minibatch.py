"""The port's heterogeneous fixed-shape sampler and the minibatch R-GCN
against ``dgl_tpu`` (``tests/test_hetero_minibatch.py``'s cases), and the
fixed-shape samplers on graphs of one edge type between two node types.

The reference's ogbn-mag-shaped graph (``synthetic_hetero_graph``) on
both sides; both pick in ``csrc/host_ops.cpp`` from the same seeds and
relabel with ``unique_and_compact``, so blocks, slot ids, masks and edge
ids are held exactly. One R-GCN step (``examples/rgcn_hetero.py``'s two
``HeteroGraphConv`` layers of ``GraphConv``) over the blocks, the
reference's weights carried by ``from_flax_params``: the logits, the loss,
every gradient and the parameters after one Adam step at rtol = 1e-4,
atol = 1e-4 * max|ref| (f32 sums in another order; Adam divides by
``sqrt(v) + eps``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

import dgl_tpu
from dgl_tpu.data.synthetic import synthetic_hetero_graph
from dgl_tpu.dataloading import HeteroFixedShapeNeighborSampler as JSampler
from dgl_tpu.nn import HeteroGraphConv as JHeteroGraphConv
from dgl_tpu.nn.conv import GraphConv as JGraphConv
import dgl_tpu_torch as dt
from dgl_tpu_torch.base import EID, NID, DGLError
from dgl_tpu_torch.dataloading import (FixedShapeNeighborSampler,
                                       HeteroFixedShapeNeighborSampler)
from dgl_tpu_torch.nn import GraphConv, HeteroGraphConv
from dgl_tpu_torch.sampling import DeviceNeighborSampler

from test_torch_dataloading import same_output
from test_torch_sampling import reference_native

FANOUT = {("paper", "cites", "paper"): 5, ("author", "writes", "paper"): 3}
ETYPES = ("cites", "writes")


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    reference_native()


@pytest.fixture(scope="module")
def mag():
    jg = synthetic_hetero_graph()
    data = {cet: (np.asarray(jg._relations[cet].src),
                  np.asarray(jg._relations[cet].dst))
            for cet in jg.canonical_etypes}
    tg = dt.heterograph(data, {nt: jg.num_nodes(nt) for nt in jg.ntypes},
                        device="cpu")
    for nt in jg.ntypes:
        for k, v in jg._node_frames[nt].items():
            tg._node_frames.setdefault(nt, {})[k] = torch.from_numpy(
                np.array(v))
    return jg, tg


def _samplers(mag, fanouts, batch, **kw):
    jg, tg = mag
    return (JSampler(jg, fanouts, batch_size=batch, seed_ntype="paper",
                     seed=0, **kw),
            HeteroFixedShapeNeighborSampler(tg, fanouts, batch,
                                            seed_ntype="paper", seed=0,
                                            device="cpu", **kw))


@pytest.mark.parametrize("kw", [dict(), dict(replace=True)])
def test_blocks_match_reference_and_keep_their_shapes(mag, kw):
    """Three batches, the last short; every block equal to the
    reference's, and the shapes the same from batch to batch."""
    jg, tg = mag
    js, ts = _samplers(mag, [FANOUT, FANOUT], 8, **kw)
    shapes = set()
    for seeds in (np.arange(8), np.arange(50, 58), np.arange(3)):
        ref = js.sample_blocks(jg, seeds)
        got = ts.sample_blocks(tg, {"paper": torch.from_numpy(seeds)})
        same_output(got[0], {k: np.asarray(v) for k, v in ref[0].items()})
        same_output(got[2], ref[2])
        shapes.add(tuple(
            (tuple(b._num_src_nodes.items()), tuple(b._num_dst_nodes.items()),
             tuple((c, r.num_edges_padded)
                   for c, r in b._relations.items())) for b in got[2]))
    assert len(shapes) == 1
    assert ts.caps == js._caps


def test_exclusion_matches_reference(mag):
    jg, tg = mag
    js, ts = _samplers(mag, [FANOUT], 8)
    cet = ("paper", "cites", "paper")
    excl = {cet: np.asarray(jg._relations[cet].csc_eids)[:40]}
    ref = js.sample_blocks(jg, np.arange(8), exclude_eids=excl)
    got = ts.sample_blocks(tg, np.arange(8), exclude_eids=excl)
    same_output(got[2], ref[2])
    eid = got[2][0]._edge_frames[cet][EID].numpy()
    mask = got[2][0]._edge_frames[cet]["_mask"].numpy()
    assert not np.isin(eid[mask], excl[cet]).any()
    with pytest.raises(TypeError):
        ts.sample_blocks(tg, np.arange(8), exclude_eids=np.arange(3))


class _JRGCN(fnn.Module):
    """``tests/test_hetero_minibatch.py``'s ``MiniHeteroRGCN``."""

    @fnn.compact
    def __call__(self, blocks, inputs):
        h = JHeteroGraphConv(
            {et: JGraphConv(12, 8, allow_zero_in_degree=True,
                            name=f"l0_{et}") for et in ETYPES},
            aggregate="sum", name="layer0")(blocks[0], inputs)
        h = {k: jax.nn.relu(v) for k, v in h.items()}
        return JHeteroGraphConv(
            {et: JGraphConv(8, 5, allow_zero_in_degree=True,
                            name=f"l1_{et}") for et in ETYPES},
            aggregate="sum", name="layer1")(blocks[1], h)["paper"]


class _RGCN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.layer0 = HeteroGraphConv(
            {et: GraphConv(12, 8, allow_zero_in_degree=True, device="cpu")
             for et in ETYPES}, aggregate="sum")
        self.layer1 = HeteroGraphConv(
            {et: GraphConv(8, 5, allow_zero_in_degree=True, device="cpu")
             for et in ETYPES}, aggregate="sum")

    def forward(self, blocks, inputs):
        h = {k: torch.relu(v)
             for k, v in self.layer0(blocks[0], inputs).items()}
        return self.layer1(blocks[1], h)["paper"]


def test_rgcn_step_over_hetero_blocks(mag):
    jg, tg = mag
    js, ts = _samplers(mag, [FANOUT, FANOUT], 16)
    train = np.nonzero(np.asarray(jg._node_frames["paper"]["train_mask"]))[0]
    jblocks = js.sample_blocks(jg, train[:16])[2]
    tblocks = ts.sample_blocks(tg, train[:16])[2]
    rng = np.random.default_rng(30)
    feats = {nt: rng.normal(size=(jg.num_nodes(nt), 12)).astype(np.float32)
             for nt in jg.ntypes}
    labels = rng.integers(0, 5, jg.num_nodes("paper"))
    src, dst = tblocks[0]._node_frames, tblocks[-1]._dst_frames["paper"]
    x = {nt: feats[nt][src[nt][NID].numpy()]
         * src[nt]["_mask"].numpy()[:, None] for nt in tblocks[0].srctypes}
    y = labels[dst[NID].numpy()]
    m = dst["_mask"].numpy().astype(np.float32)
    jm = _JRGCN()
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jblocks, jx)

    def jloss(p):
        logits = jm.apply(p, jblocks, jx)
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y))
        return (ls * m).sum() / jnp.maximum(m.sum(), 1), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    tx = optax.adam(5e-3)
    jnew = optax.apply_updates(params, tx.update(jgrads,
                                                 tx.init(params))[0])
    # flax makes the GraphConvs children of the module that builds them;
    # layer 1's writes (source author, which has no input there) is never
    # called, so flax has no parameters for it and it takes no part
    rename = {f"l{i}_{et}": f"layer{i}.mods.{et}"
              for i in (0, 1) for et in ETYPES}
    unused = {"layer1.mods.writes.weight", "layer1.mods.writes.bias"}
    tm = _RGCN()
    sd = dt.from_flax_params(params, rename)
    assert set(sd) == set(tm.state_dict()) - unused
    tm.load_state_dict(sd, strict=False)
    opt = torch.optim.Adam(tm.parameters(), lr=5e-3)
    logits = tm(tblocks, {k: torch.from_numpy(v) for k, v in x.items()})
    tmask = torch.from_numpy(m)
    ce = F.cross_entropy(logits, torch.from_numpy(y), reduction="none")
    loss = (ce * tmask).sum() / torch.clamp(tmask.sum(), min=1)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()
             if k not in unused}
    opt.step()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)

    assert logits.shape == (17, 5)
    close(logits.detach().numpy(), jlogits, "logits")
    close(loss.item(), jl, "loss")
    new = {k: v for k, v in tm.state_dict().items() if k not in unused}
    for tree, got in ((jgrads, grads), (jnew, new)):
        want = dt.from_flax_params(tree, rename)
        assert set(got) == set(want)
        for k, v in got.items():
            close(v.detach().numpy(), want[k].numpy(), k)


# ---------------------------------------------------------------------------
# the homogeneous samplers on graphs that are not homogeneous
# ---------------------------------------------------------------------------


def _bipartite():
    rng = np.random.default_rng(31)
    data = {("user", "rates", "item"): (rng.integers(0, 40, 300),
                                        rng.integers(0, 25, 300))}
    counts = {"user": 40, "item": 25}
    return (dgl_tpu.heterograph(data, counts),
            dt.heterograph(data, counts, device="cpu"))


def test_samplers_on_one_edge_type_between_two_node_types():
    """One edge type: the fixed-shape sampler (a layer over the item
    seeds) and the device sampler run as the reference does."""
    from dgl_tpu.dataloading import FixedShapeNeighborSampler as JFixed
    from dgl_tpu.sampling import DeviceNeighborSampler as JDevice

    from test_torch_minibatch import _assert_blocks_equal

    jg, tg = _bipartite()
    seeds = np.array([0, 3, 24, 7])
    ref = JFixed([4], batch_size=6, seed=2).sample_blocks(jg, seeds)
    got = FixedShapeNeighborSampler([4], 6, seed=2, device="cpu"
                                    ).sample_blocks(tg, seeds)
    _assert_blocks_equal(ref, got)
    mfg = DeviceNeighborSampler([3]).sample_from(
        torch.Generator().manual_seed(0), tg, torch.from_numpy(seeds))
    jmfg = JDevice([3]).sample_from(jax.random.PRNGKey(0), jg,
                                    jnp.asarray(seeds))
    assert mfg.nbrs[0].shape == tuple(jmfg.nbrs[0].shape)
    indptr = tg._relation().csc_indptr.numpy()
    indices = tg._relation().csc_indices.numpy()
    for row, s in enumerate(seeds):
        picks = mfg.nbrs[0][row][mfg.masks[0][row]].numpy()
        assert np.isin(picks, indices[indptr[s]:indptr[s + 1]]).all()


def test_samplers_refuse_several_edge_types(mag):
    """As in the reference: ``DGLError`` from resolving the one edge
    type."""
    from dgl_tpu.base import DGLError as JDGLError
    from dgl_tpu.dataloading import FixedShapeNeighborSampler as JFixed

    jg, tg = mag
    with pytest.raises(JDGLError):
        JFixed([2], batch_size=4).sample_blocks(jg, np.array([0, 1]))
    with pytest.raises(DGLError):
        FixedShapeNeighborSampler([2], 4, device="cpu").sample_blocks(
            tg, np.array([0, 1]))
    with pytest.raises(DGLError):
        DeviceNeighborSampler([2]).sample_from(torch.Generator(), tg,
                                               torch.tensor([0, 1]))
