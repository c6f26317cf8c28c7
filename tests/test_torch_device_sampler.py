"""The port's on-device sampler and ``DeviceSAGE`` against ``dgl_tpu``.

JAX's threefry draws are not torch's, so the sampler is held to the
reference in two ways: ``_pick``, handed the reference's own
``jax.random.uniform`` draws, must give the reference's picks; and the
whole sampler, on torch's draws, must have the reference's properties
(``tests/test_device_sampler.py``). ``DeviceSAGE`` runs on one
``DeviceMFG`` built from the reference's sampled arrays.

Tolerances: picks and masks exact. ``DeviceSAGE`` forward, gradients and
the parameters after one Adam step at rtol = atol = 1e-4 (f32 matmuls
whose last bits differ between the frameworks; Adam divides by
``sqrt(v) + eps`` with ``v`` near 0 for some entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import dgl_tpu
from dgl_tpu.models import DeviceSAGE as JDeviceSAGE
from dgl_tpu.sampling import DeviceNeighborSampler as JSampler
from dgl_tpu.sampling.device_sampler import _sample_level as j_sample_level
import dgl_tpu_torch as dt
from dgl_tpu_torch.models import DeviceSAGE
from dgl_tpu_torch.sampling import (DeviceMFG, DeviceNeighborSampler,
                                    device_seed_batches)
from dgl_tpu_torch.sampling.device_sampler import _pick

MODES = ["unique", "replace", "exact"]


def _zipf(n=2000, e=12_000, seed=0, empty_tail=0):
    """zipf sources, uniform destinations; the last ``empty_tail`` nodes
    have no in-edge."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n + 1)
    return (rng.choice(n, e, p=w / w.sum()),
            rng.integers(0, n - empty_tail, e))


def _csc(src, dst, n):
    rel = dt.graph((src, dst), num_nodes=n, device="cpu")._relation()
    return rel.csc_indptr, rel.csc_indices


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def zipf():
    src, dst = _zipf(empty_tail=2)
    return src, dst, _csc(src, dst, 2000)


@pytest.mark.parametrize("fanout", [3, 10])
@pytest.mark.parametrize("mode", MODES)
def test_pick_matches_reference_on_its_draws(zipf, mode, fanout):
    """The frontier mixes zero-degree nodes (the last two, whose offset
    is the end of the CSC, among them), rows of degree at most ``fanout``
    and high-degree hubs. Masked slots hold no pick: the reference reads
    out of range there (a fill value), the port inside the array."""
    _, _, (indptr, indices) = zipf
    deg = (indptr[1:] - indptr[:-1]).numpy()
    frontier = np.concatenate([
        np.nonzero(deg == 0)[0][-3:], np.nonzero(deg == fanout)[0][:5],
        np.nonzero((deg > 0) & (deg < fanout))[0][:20],
        np.argsort(deg)[-20:], np.arange(0, 2000, 37)]).astype(np.int32)
    assert int(indptr[1999]) == indices.shape[0] and 1999 in frontier
    key = jax.random.PRNGKey(fanout)
    jnbr, jmask = j_sample_level(key, jnp.asarray(indptr.numpy()),
                                 jnp.asarray(indices.numpy()),
                                 jnp.asarray(frontier), fanout, mode)
    u = torch.from_numpy(np.array(
        jax.random.uniform(key, (frontier.shape[0], fanout))))
    f = torch.from_numpy(frontier)
    start = indptr[f]
    pos, mask = _pick(u, start, indptr[f + 1] - start, fanout, mode)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    nbr = indices[pos[mask].to(torch.int64)]
    np.testing.assert_array_equal(nbr.numpy(),
                                  np.asarray(jnbr)[np.asarray(jmask)])
    assert mask.any() and not mask.all()


def _toy(n=40, e=160, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return dt.graph((src, dst), num_nodes=n, device="cpu"), src, dst


@pytest.mark.parametrize("mode", MODES)
def test_take_all_rows(mode):
    """With ``fanout`` above every in-degree each node takes all its
    in-neighbours, in CSC order, and nothing else."""
    g, src, dst = _toy()
    n = g.num_nodes()
    fanout = int(np.bincount(dst, minlength=n).max()) + 1
    s = DeviceNeighborSampler([fanout], mode=mode)
    mfg = s.sample_from(_gen(0), g, torch.arange(n))
    rel = g._relation()
    for v in range(n):
        lo, hi = int(rel.csc_indptr[v]), int(rel.csc_indptr[v + 1])
        m = mfg.masks[0][v]
        assert m[:hi - lo].all() and not m[hi - lo:].any()
        assert mfg.nbrs[0][v][:hi - lo].tolist() == (
            rel.csc_indices[lo:hi].tolist())


@pytest.mark.parametrize("mode", MODES)
def test_shapes_static_and_picks_are_in_neighbours(mode):
    g, _, _ = _toy()
    s = DeviceNeighborSampler([3, 5], mode=mode)
    mfg = s.sample_from(_gen(1), g, torch.arange(8))
    assert isinstance(mfg, DeviceMFG) and mfg.num_layers == 2
    assert [f.shape for f in mfg.frontiers] == [(8,), (48,), (192,)]
    assert [b.shape for b in mfg.nbrs] == [(8, 5), (48, 3)]
    assert all(b.dtype == torch.int32 for b in mfg.nbrs + mfg.frontiers)
    assert mfg.input_nodes() is mfg.frontiers[-1]
    rel = g._relation()
    ip, ix = rel.csc_indptr, rel.csc_indices
    for depth in range(2):
        for r, v in enumerate(mfg.frontiers[depth].tolist()):
            nb = set(ix[ip[v]:ip[v + 1]].tolist())
            row, m = mfg.nbrs[depth][r], mfg.masks[depth][r]
            assert set(row[m].tolist()) <= nb
            if mode != "replace":  # distinct picks
                assert len(set(row[m].tolist())) <= int(m.sum())
        nxt = mfg.frontiers[depth + 1]
        assert torch.equal(nxt[:mfg.frontiers[depth].shape[0]],
                           mfg.frontiers[depth])
    assert int(mfg.num_real_edges()) == sum(int(m.sum())
                                            for m in mfg.masks)


def test_unique_and_exact_modes_pick_distinct_offsets():
    """One node with 7 in-edges from distinct sources and fanout 6: with
    replacement, 6 draws repeat an offset with probability 0.96; unique
    masks the repeats, exact draws 6 distinct offsets."""
    g = dt.graph((np.arange(1, 8), np.zeros(7, np.int64)), num_nodes=8,
                 device="cpu")
    seeds = torch.zeros(64, dtype=torch.int64)
    dup_seen = False
    for mode in ("replace", "unique", "exact"):
        mfg = DeviceNeighborSampler([6], mode=mode).sample_from(
            _gen(2), g, seeds)
        nbr, m = mfg.nbrs[0], mfg.masks[0]
        for r in range(64):
            picks = nbr[r][m[r]].tolist()
            if mode == "replace":
                dup_seen |= len(set(picks)) < len(picks)
            else:
                assert len(set(picks)) == len(picks)
            if mode == "exact":
                assert len(picks) == 6
    assert dup_seen


def test_seed_mask_propagates():
    g, _, _ = _toy()
    smask = torch.tensor([True] * 5 + [False] * 3)
    mfg = DeviceNeighborSampler([2, 4]).sample_from(
        _gen(0), g, torch.arange(8), seed_mask=smask)
    assert mfg.masks[0][:5].any() and not mfg.masks[0][5:].any()
    # the masked seeds and their picks stay masked a layer further in
    assert not mfg.masks[1][5:8].any()
    assert not mfg.masks[1][8:].reshape(8, 4, 2)[5:].any()
    assert int(mfg.num_real_edges()) == int(mfg.masks[0][:5].sum()) + int(
        mfg.masks[1].sum())


def test_device_seed_batches():
    ids, mask = device_seed_batches(_gen(0), 103, 16, device="cpu")
    assert ids.shape == mask.shape == (7, 16)
    assert sorted(ids[mask].tolist()) == list(range(103))
    assert not mask[-1, 103 - 96:].any()
    tm = torch.tensor([True, False] * 50)
    ids, mask = device_seed_batches(_gen(1), 100, 10, tm, device="cpu")
    assert sorted(ids[mask].tolist()) == list(range(0, 100, 2))
    a, _ = device_seed_batches(_gen(5), 50, 8, device="cpu")
    b, _ = device_seed_batches(_gen(5), 50, 8, device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="generator"):
        device_seed_batches(_gen(0), 10, 4, device="meta")


def _reference_mfg(n_layers=2):
    """The reference's sampled arrays on a graph with self-loops, and the
    same arrays as a port ``DeviceMFG``."""
    src, dst = _zipf(300, 1500, 4)
    g = dgl_tpu.add_self_loop(dgl_tpu.graph((src, dst), num_nodes=300))
    s = JSampler([4, 3][:n_layers])
    jm = jax.jit(lambda key: s.sample_from(
        key, g, jnp.arange(0, 300, 7, dtype=jnp.int32),
        seed_mask=jnp.arange(43) < 40))(jax.random.PRNGKey(0))
    tm = DeviceMFG(*[[torch.from_numpy(np.array(a)) for a in part]
                     for part in (jm.frontiers, jm.nbrs, jm.masks)],
                   torch.from_numpy(np.array(jm.seed_mask)))
    return jm, tm


def test_device_sage_matches_reference():
    """Forward, gradients of the masked loss and one Adam step at 1e-3,
    with the reference's weights carried over by ``from_flax_params``
    (its parameter tree maps onto the port's names unchanged)."""
    jmfg, tmfg = _reference_mfg()
    rng = np.random.default_rng(3)
    n_in = tmfg.input_nodes().shape[0]
    x = rng.normal(size=(n_in, 6)).astype(np.float32)
    y = rng.integers(0, 5, 43).astype(np.int32)
    w = np.asarray(jmfg.seed_mask, np.float32)
    jm = JDeviceSAGE(6, 16, 5, num_layers=2)
    params = jm.init(jax.random.PRNGKey(1), jmfg, jnp.asarray(x))

    def jloss(p):
        logits = jm.apply(p, jmfg, jnp.asarray(x))
        ls = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y))
        return (ls * w).sum() / jnp.maximum(w.sum(), 1), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, upd)

    tm = DeviceSAGE(6, 16, 5, num_layers=2, device="cpu")
    state = dt.from_flax_params(params)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    logits = tm(tmfg, torch.from_numpy(x))
    tw = torch.from_numpy(w)
    ls = F.cross_entropy(logits, torch.from_numpy(y).long(),
                         reduction="none")
    ((ls * tw).sum() / torch.clamp(tw.sum(), min=1)).backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **tol)
    for tree, got in ((jgrads, grads), (jnew, dict(tm.state_dict()))):
        for k, v in dt.from_flax_params(tree).items():
            np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                       err_msg=k, **tol)


def test_device_sage_checks_layers():
    _, tmfg = _reference_mfg(n_layers=1)
    tm = DeviceSAGE(6, 16, 5, num_layers=2, device="cpu")
    with pytest.raises(ValueError, match="1 layers"):
        tm(tmfg, torch.zeros(tmfg.input_nodes().shape[0], 6))


def test_epoch_trains():
    """Two sampled-training epochs on the CPU, as
    ``test_epoch_scan_trains`` runs them: every step samples, gathers,
    steps Adam; the second epoch's mean loss is below the first's."""
    src, dst = _zipf(64, 300, 5)
    loops = np.arange(64)
    g = dt.graph((np.concatenate([src, loops]), np.concatenate([dst, loops])),
                 num_nodes=64, device="cpu")
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(64, 5)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, 64))
    s = DeviceNeighborSampler([3, 3])
    model = DeviceSAGE(5, 8, 3, num_layers=2,
                       generator=torch.Generator().manual_seed(1),
                       device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    rel = g._relation()
    gen = _gen(2)
    means = []
    for _ in range(6):
        ids, mask = device_seed_batches(gen, 64, 16, device="cpu")
        losses = []
        for seeds, smask in zip(ids, mask):
            mfg = s.sample(gen, rel.csc_indptr, rel.csc_indices, seeds,
                           seed_mask=smask)
            logits = model(mfg, feats[mfg.input_nodes().long()])
            w = smask.float()
            ls = F.cross_entropy(logits, labels[seeds], reduction="none")
            loss = (ls * w).sum() / torch.clamp(w.sum(), min=1)
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
        means.append(np.mean(losses))
    assert np.isfinite(means).all()
    assert means[-1] < means[0], means
