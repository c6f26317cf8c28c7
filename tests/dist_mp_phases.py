"""The seven phases of ``__graft_entry__.dryrun_multichip`` at its
``DGL_TPU_DRYRUN_SMALL`` shapes, over the port's meshes, for
``test_torch_distributed_mp.py``. Imports no JAX: the gloo worker
processes run it.

``run_phases(gp_mesh, dp_tp_mesh)`` returns a dict of numpy results:
keys starting with ``part:`` carry the parts held here in front (all four
on the one-process mesh, one across processes); the others are the same
on every part (losses, replicated weights, byte counts).
"""
import numpy as np
import torch
import torch.nn.functional as F

import dgl_tpu_torch as dt
import dgl_tpu_torch.distributed as td
import dgl_tpu_torch.parallel as tpar

N_DEV = 4


def _np(x):
    return x.detach().cpu().numpy()


def _total(mesh, x, axis="gp"):
    """The sum over every part of a per-part value (no gradient)."""
    x = x.detach()
    if mesh.one_process:
        return x.sum(0)
    return mesh.psum(x, axis)[0]


def phase1(mesh, out):
    """dp x tp: GraphSAGE over a batch of graphs with a sharded embedding,
    Adam 1e-3, gradients averaged over dp."""
    from dgl_tpu_torch.models import GraphSAGE

    dp = mesh.shape["dp"]
    rng = np.random.default_rng(0)
    B, N, E, VOCAB, fin, hid, cls = dp, 64, 256, 128, 32, 64, 8
    graphs = [dt.graph((rng.integers(0, N, E), rng.integers(0, N, E)),
                       num_nodes=N, device="cpu") for _ in range(B)]
    node_ids = rng.integers(0, VOCAB, (B, N))
    labels = rng.integers(0, cls, (B, N))
    torch.manual_seed(0)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sage = GraphSAGE(fin, hid, cls, num_layers=2,
                                  device="cpu").eval()
            self.embedding = torch.nn.Parameter(torch.from_numpy(
                rng.normal(size=(VOCAB, fin)).astype(np.float32)))

    model = tpar.param_shardings(mesh, Model(), {
        r"embedding": tpar.PartitionSpec("tp", None)})
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def loss_fn(model, batch):
        gs, ids, y = batch
        return torch.stack([F.cross_entropy(
            model.sage(g, model.embedding[i]), t)
            for g, i, t in zip(gs, ids, y)]).mean()

    step = tpar.sharded_train_step(mesh, loss_fn, opt)
    loss = step(model, tpar.shard_batch(mesh, (graphs, node_ids, labels)))
    out["p1_loss"] = _np(loss)
    for name, p in model.named_parameters():
        out[f"p1_{name}"] = _np(p)


def phase2(mesh, out):
    """Full-graph step over 4 shards: ``dist_copy_u_sum(mean)``, a linear,
    cross-entropy over every padded row, SGD 0.1."""
    rng = np.random.default_rng(1)
    gN, gE, gF, gC = 8 * N_DEV, 32 * N_DEV, 16, 4
    g = dt.graph((rng.integers(0, gN, gE), rng.integers(0, gN, gE)),
                 num_nodes=gN, device="cpu")
    parts = td.random_partition_assignment(g, N_DEV, seed=0)
    shards = td.build_shards(g, parts, N_DEV)
    tables = td.shard_arrays(mesh, shards)
    x = shards.shard_features(rng.normal(size=(gN, gF)).astype(np.float32))
    y = mesh.local(torch.from_numpy(
        rng.integers(0, gC, (N_DEV, shards.n_max))))
    w = torch.from_numpy((rng.normal(size=(gF, gC)) * 0.1).astype(
        np.float32)).requires_grad_(True)
    h = td.dist_copy_u_sum(mesh, shards, x, tables=tables, mean=True)
    ls = F.cross_entropy((h @ w).reshape(-1, gC), y.reshape(-1),
                         reduction="none").reshape(y.shape)
    loss_parts = ls.sum(1) / (N_DEV * shards.n_max)
    loss_parts.sum().backward()
    mesh.sum_grads([w])
    out["part:p2_h"] = _np(h)
    out["p2_loss"] = _np(_total(mesh, loss_parts))
    out["p2_w"] = _np(w.detach() - 0.1 * w.grad)


def phase3(mesh, out):
    """Heterogeneous shards: the plain, edge-weighted and delayed
    per-etype halo aggregations."""
    from dgl_tpu_torch.data import synthetic_hetero_graph

    hg = synthetic_hetero_graph(
        num_nodes_dict={"paper": 8 * N_DEV, "author": 4 * N_DEV,
                        "institution": 2 * N_DEV, "field": 2 * N_DEV},
        num_edges_dict={("paper", "cites", "paper"): 32 * N_DEV,
                        ("author", "writes", "paper"): 16 * N_DEV,
                        ("author", "affiliated_with", "institution"):
                            8 * N_DEV,
                        ("paper", "has_topic", "field"): 8 * N_DEV},
        feat_dim=8, device="cpu")
    rng = np.random.default_rng(2)
    assign = td.hetero_partition_assignment(hg, N_DEV)
    hs = td.build_hetero_shards(hg, assign, N_DEV)
    hx = hs.shard_features({nt: rng.normal(size=(hg.num_nodes(nt), 8))
                            .astype(np.float32) for nt in hg.ntypes})
    hew = {cet: hs.shard_edge_data(cet, rng.normal(
        size=(hg.num_edges(cet),)).astype(np.float32))
        for cet in hg.canonical_etypes}
    plain = td.dist_hetero_copy_u_sum(mesh, hs, hx)
    weighted = td.dist_hetero_copy_u_sum(mesh, hs, hx, eweights=hew)
    st = td.init_hetero_halo_state(mesh, hs, {nt: 8 for nt in hg.ntypes})
    _, st = td.dist_hetero_copy_u_sum_delayed(mesh, hs, hx, st)
    delayed, _ = td.dist_hetero_copy_u_sum_delayed(mesh, hs, hx, st)
    for nt in hg.ntypes:
        out[f"part:p3_plain_{nt}"] = _np(plain[nt])
        out[f"part:p3_weighted_{nt}"] = _np(weighted[nt])
        out[f"part:p3_delayed_{nt}"] = _np(delayed[nt])


def _minibatch_graph():
    rng = np.random.default_rng(3)
    mbN, mbE, mbF, mbC = 16 * N_DEV, 64 * N_DEV, 8, 4
    g = dt.graph((rng.integers(0, mbN, mbE), rng.integers(0, mbN, mbE)),
                 num_nodes=mbN, device="cpu")
    parts = td.random_partition_assignment(g, N_DEV, seed=1)
    pg = td.PartitionedGraphCSC.build(g, parts, N_DEV)
    x_old = rng.normal(size=(mbN, mbF)).astype(np.float32)
    y_old = rng.integers(0, mbC, mbN).astype(np.float32)
    w = (rng.normal(size=(mbF, mbC)) * 0.1).astype(np.float32)
    return (g, pg, pg.shard_rows(x_old, device="cpu"),
            pg.shard_rows(y_old[:, None], device="cpu"), w)


def phase4(mesh, out, mb):
    """Host-sampled DistDGL minibatch: owner-grouped sampling, the
    feature and label pulls, a 2-layer mean aggregation, masked
    cross-entropy over every part's seeds."""
    g, pg, ftable, ltable, w0 = mb
    B = 4
    sampler = td.DistNeighborSampler(pg, [3, 3], batch_size=B, seed=0,
                                     device="cpu")
    loader = td.DistNodeDataLoader(pg, np.arange(pg.num_nodes), sampler,
                                   batch_size=B, shuffle=False)
    in_ids, out_ids, blocks = next(iter(loader))
    x = td.sparse_all_to_all_pull(mesh, pg.ranges, ftable, in_ids)
    y = td.sparse_all_to_all_pull(mesh, pg.ranges, ltable,
                                  torch.clamp(out_ids, min=0))[..., 0].long()
    count = max(int((out_ids >= 0).sum()), 1)
    m = mesh.local(out_ids >= 0).float()
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    parts = range(mesh.coord("gp"), mesh.coord("gp") + mesh.parts("gp"))
    loss_parts = []
    for l, p in enumerate(parts):
        b0, b1 = blocks[0][p], blocks[1][p]
        h = x[l] * b0.srcdata["_mask"][:, None].float()
        h = torch.relu(dt.ops.copy_u_mean(b0, h) @ w)
        logits = dt.ops.copy_u_mean(b1, h)[: y.shape[1]]
        ls = F.cross_entropy(logits, y[l], reduction="none")
        loss_parts.append((ls * m[l]).sum() / count)
    loss_parts = torch.stack(loss_parts)
    loss_parts.sum().backward()
    mesh.sum_grads([w])
    out["part:p4_x"] = _np(x)
    out["p4_loss"] = _np(_total(mesh, loss_parts))
    out["p4_w"] = _np(w.detach() - 0.1 * w.grad)


def phase5(mesh, out, mb):
    """Distributed link prediction: edge splits, uniform negatives, a
    dot-product decoder over the pulled features."""
    g, pg, ftable, ltable, w0 = mb
    esrc, edst = (t.numpy() for t in g.edges())
    edges = np.stack([pg.new_of_old[esrc[::4]], pg.new_of_old[edst[::4]]], 1)
    loader = td.DistEdgeDataLoader(pg, edges, fanouts=[3], batch_size=2,
                                   num_negatives=2, seed=0, device="cpu")
    pos, neg, _, pidx, nidx, in_ids, blocks = next(iter(loader))
    x = td.sparse_all_to_all_pull(mesh, pg.ranges, ftable, in_ids)
    pos, pidx, nidx = (mesh.local(t) for t in (pos, pidx, nidx))
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    parts = range(mesh.coord("gp"), mesh.coord("gp") + mesh.parts("gp"))
    total = max(int(_total(mesh, (pos[:, :, 0] >= 0).sum(1).double())), 1)
    loss_parts = []
    for l, p in enumerate(parts):
        b0 = blocks[0][p]
        h = x[l] * b0.srcdata["_mask"][:, None].float()
        h = dt.ops.copy_u_mean(b0, h) @ w
        a = h[pidx[l, :, 0]]
        pos_s = (a * h[pidx[l, :, 1]]).sum(-1)
        neg_s = (a[:, None, :] * h[nidx[l]]).sum(-1)
        per = (F.binary_cross_entropy_with_logits(
            pos_s, torch.ones_like(pos_s), reduction="none")
            + F.binary_cross_entropy_with_logits(
                neg_s, torch.zeros_like(neg_s), reduction="none").mean(-1))
        mm = (pos[l, :, 0] >= 0).float()
        loss_parts.append((per * mm).sum() / total)
    loss_parts = torch.stack(loss_parts)
    loss_parts.sum().backward()
    mesh.sum_grads([w])
    out["p5_loss"] = _np(_total(mesh, loss_parts))
    out["p5_w"] = _np(w.detach() - 0.1 * w.grad)


def _device_step(mesh, pg, ftable, ltable, w, sampler, gens, seeds,
                 feat_dtype=torch.float32):
    """Sample on the device, pull features and labels, mean-aggregate each
    layer from the fixed-fanout slots; the per-part mean cross-entropy,
    averaged over the parts. Returns the per-part losses."""
    ip, ix = td.shard_csc_arrays(pg, device=mesh.device)
    mfg = sampler.sample_shard(mesh, gens, ip, ix, seeds)
    x = td.pull_rows_in_shard_map(mesh, pg.ranges, ftable.to(feat_dtype),
                                  mfg.input_nodes()).float()
    y = td.pull_rows_in_shard_map(mesh, pg.ranges, ltable,
                                  seeds)[..., 0].long()
    h = x
    for li in range(mfg.num_layers - 1, -1, -1):
        npar = mfg.frontiers[li].shape[1]
        fo = mfg.nbrs[li].shape[2]
        nb = h[:, npar:].reshape(h.shape[0], npar, fo, -1)
        msk = mfg.masks[li][..., None].float()
        h = h[:, :npar] + (nb * msk).sum(2) / torch.clamp(msk.sum(2),
                                                          min=1.0)
    logits = h @ w
    ls = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         y.reshape(-1), reduction="none").reshape(y.shape)
    return ls.mean(1) / mesh.shape["gp"]


def phase6(mesh, out, mb):
    """The on-device distributed sampler: 2 steps of sample, pull and a
    gradient step averaged over the parts."""
    g, pg, ftable, ltable, w0 = mb
    rng = np.random.default_rng(6)
    B, S, fan = 4, 2, [2, 2]
    sampler = td.DeviceDistSampler(fan, pg.ranges)
    seeds = torch.from_numpy(rng.integers(0, pg.num_nodes, (N_DEV, S, B)))
    gens = [torch.Generator().manual_seed(3 + p) for p in range(N_DEV)]
    w = torch.from_numpy(w0.copy())
    losses = []
    for s in range(S):
        w = w.detach().requires_grad_(True)
        lp = _device_step(mesh, pg, ftable, ltable, w, sampler, gens,
                          seeds[:, s])
        lp.sum().backward()
        mesh.sum_grads([w])
        losses.append(_np(_total(mesh, lp)))
        w = w.detach() - 0.1 * w.grad
    out["p6_losses"] = np.stack(losses)
    out["p6_w"] = _np(w)
    out["p6_comm_bytes_per_step"] = np.asarray(
        sampler.comm_bytes_per_sample(B, N_DEV))


def phase7(mesh, out, mb):
    """The flagship's code path small: fanouts [3, 2, 2], the bf16
    feature pull, and the byte audit (the exchanged integer bytes a part
    against the analytic count)."""
    g, pg, ftable, ltable, w0 = mb
    rng = np.random.default_rng(7)
    B, fan = 8, [3, 2, 2]
    sampler = td.DeviceDistSampler(fan, pg.ranges)
    seeds = torch.from_numpy(rng.integers(0, pg.num_nodes, (N_DEV, B)))
    gens = [torch.Generator().manual_seed(7 + p) for p in range(N_DEV)]
    w = torch.from_numpy(w0.copy()).requires_grad_(True)
    mesh.reset_comm_bytes()
    lp = _device_step(mesh, pg, ftable, ltable, w, sampler, gens, seeds,
                      feat_dtype=torch.bfloat16)
    lp.sum().backward()
    mesh.sum_grads([w])
    m_in = B
    for f in fan:
        m_in *= f + 1
    analytic = sampler.comm_bytes_per_sample(B, N_DEV) + N_DEV * (
        m_in + B) * 4
    out["p7_loss"] = _np(_total(mesh, lp))
    out["p7_w"] = _np(w.detach() - 0.1 * w.grad)
    out["p7_int_bytes"] = np.asarray(mesh.comm_bytes["int"])
    out["p7_float_bytes"] = np.asarray(mesh.comm_bytes["float"])
    out["p7_analytic_int_bytes"] = np.asarray(analytic)


def run_phases(gp_mesh, dp_tp_mesh) -> dict:
    out = {}
    phase1(dp_tp_mesh, out)
    phase2(gp_mesh, out)
    phase3(gp_mesh, out)
    mb = _minibatch_graph()
    phase4(gp_mesh, out, mb)
    phase5(gp_mesh, out, mb)
    phase6(gp_mesh, out, mb)
    phase7(gp_mesh, out, mb)
    return out


def worker(rank: int, world: int, port: int, out_dir: str):
    """One gloo process: join the group through ``initialize``, build the
    meshes over it, run the phases, save the results."""
    import os

    td.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=world, process_id=rank, device="cpu")
    try:
        gp = tpar.create_mesh((world,), ("gp",), group=True, device="cpu")
        dptp = tpar.create_mesh((2, world // 2), ("dp", "tp"), group=True,
                                device="cpu")
        out = run_phases(gp, dptp)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        td.exit_client()
