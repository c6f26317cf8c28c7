"""The port's distributed layer (``dgl_tpu_torch.distributed`` and
``dgl_tpu_torch.parallel``) against ``dgl_tpu``'s: shards, halo exchange
and aggregation, the sparse all-to-all, the distributed tensors and
optimisers, the host services, and dryrun phase 1's data-parallel step.

The reference runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port on an 8-part one-process mesh on the CPU (``create_mesh(...,
device="cpu")``). Index arrays are held exactly; aggregations and their
gradients at rtol 1e-5, atol 1e-5 * max|ref| (f32 sums in another order).
The minibatch path is in ``test_torch_dist_minibatch.py``, the gloo
processes in ``test_torch_distributed_mp.py``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgl_tpu
import dgl_tpu.distributed as jd
import dgl_tpu.parallel as jpar
import importlib
jds = importlib.import_module("dgl_tpu.distributed.dist_spmm")
import dgl_tpu_torch as dt
import dgl_tpu_torch.distributed as td
import dgl_tpu_torch.parallel as tpar

from test_torch_graph_utils import np_of

P = 8


def close(got, ref, what="value", tol=1e-5):
    r = np_of(ref).astype(np.float64)
    np.testing.assert_allclose(np_of(got).astype(np.float64), r, rtol=tol,
                               atol=tol * max(np.abs(r).max(), 1e-30),
                               err_msg=what)


def exact(got, ref, what="value"):
    g, r = np_of(got), np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    assert np.array_equal(g, r), what


@pytest.fixture(scope="module")
def meshes():
    return (jpar.create_mesh((P,), ("gp",)),
            tpar.create_mesh((P,), ("gp",), device="cpu"))


def graph_pair(n=120, e=700, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    return (dgl_tpu.graph((src, dst), num_nodes=n),
            dt.graph((src, dst), num_nodes=n, device="cpu"))


def assignments(jg, kind, n):
    rng = np.random.default_rng(3)
    if kind == "random":
        return jd.random_partition_assignment(jg, P, seed=0)
    if kind == "metis":
        return np.asarray(jd.metis_partition_assignment(jg, P))
    if kind == "empty_part":  # part 5 owns nothing
        parts = rng.integers(0, P, n)
        return np.where(parts == 5, 6, parts)
    # "no_halo": the edges stay inside part 0's and 1's blocks
    return np.where(np.arange(n) < n // 2, 0, 1 + np.arange(n) % (P - 1))


SHARD_FIELDS = ("src_ext", "dst_local", "edge_mask", "send_idx",
                "send_mask", "in_deg", "order", "new_of_old", "n_owned",
                "ranges")


@pytest.mark.parametrize("kind", ["random", "metis", "empty_part",
                                  "no_halo"])
def test_build_shards_match_reference(kind):
    if kind == "no_halo":
        n = 64
        src = np.arange(n // 2)
        dst = (src * 7 + 3) % (n // 2)
        jg = dgl_tpu.graph((src, dst), num_nodes=n)
        tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    else:
        n = 120
        jg, tg = graph_pair(n)
    parts = assignments(jg, kind, n)
    ref = jd.build_shards(jg, parts, P)
    got = td.build_shards(tg, torch.from_numpy(np.asarray(parts)), P)
    for k in ("num_parts", "n_max", "e_max", "h_max"):
        assert getattr(got, k) == getattr(ref, k), k
    for f in SHARD_FIELDS:
        exact(getattr(got, f), np.asarray(getattr(ref, f)), f)
    if kind == "no_halo":
        assert not np_of(got.send_mask).any()
    x = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    exact(got.shard_features(x), np.asarray(ref.shard_features(x)))
    exact(got.unshard(got.shard_features(x)), x)


def hetero_pair(seed=4):
    from dgl_tpu_torch.data import synthetic_hetero_graph as tsyn
    from dgl_tpu.data import synthetic_hetero_graph as jsyn

    kw = dict(num_nodes_dict={"paper": 64, "author": 32, "institution": 16,
                              "field": 16},
              num_edges_dict={("paper", "cites", "paper"): 256,
                              ("author", "writes", "paper"): 128,
                              ("author", "affiliated_with",
                               "institution"): 64,
                              ("paper", "has_topic", "field"): 64},
              feat_dim=8, seed=seed)
    return jsyn(**kw), tsyn(**kw, device="cpu")


@pytest.fixture(scope="module")
def hetero():
    jg, tg = hetero_pair()
    assign = jd.partition.hetero_partition_assignment(jg, P)
    return jg, tg, assign


def test_build_hetero_shards_match_reference(hetero):
    jg, tg, assign = hetero
    tassign = td.hetero_partition_assignment(tg, P)
    for nt in assign:
        exact(tassign[nt], np.asarray(assign[nt]), nt)
    ref = jd.build_hetero_shards(jg, assign, P)
    got = td.build_hetero_shards(tg, tassign, P)
    assert got.ntypes == ref.ntypes and got.cetypes == ref.cetypes
    for k in ("n_max", "h_max", "e_max"):
        assert getattr(got, k) == getattr(ref, k), k
    for k in ("ranges", "order", "new_of_old", "send_idx", "send_mask",
              "src_ext", "dst_local", "in_deg", "eids_tbl", "e_mask"):
        for key, v in getattr(ref, k).items():
            exact(getattr(got, k)[key], np.asarray(v), f"{k}[{key}]")
    w = np.random.default_rng(2).normal(size=(128,)).astype(np.float32)
    cet = ("author", "writes", "paper")
    exact(got.shard_edge_data(cet, w), np.asarray(ref.shard_edge_data(cet, w)))


@pytest.fixture(scope="module")
def shards_pair():
    jg, tg = graph_pair(160, 900, seed=5)
    parts = jd.random_partition_assignment(jg, P, seed=1)
    return jd.build_shards(jg, parts, P), td.build_shards(tg, parts, P), 160


def _grads(fn_j, fn_t, args_j, args_t, cot):
    """Output and gradients in every argument: ``jax.vjp`` of the
    reference, ``torch.autograd.grad`` of the port, one cotangent."""
    out_j, vjp = jax.vjp(jax.jit(fn_j), *args_j)
    g_j = jax.jit(vjp)(jnp.asarray(cot))
    args_t = [torch.as_tensor(np.array(a)).requires_grad_(True)
              for a in args_t]
    out_t = fn_t(*args_t)
    g_t = torch.autograd.grad(out_t, args_t, torch.from_numpy(cot))
    return out_j, out_t, g_j, g_t


AGG_CASES = ["copy_u_sum", "copy_u_mean", "sum", "mean", "max", "min",
             "sum_ev", "mean_ev", "max_ev", "min_ev"]


@pytest.mark.parametrize("case", AGG_CASES)
def test_dist_aggregations_and_gradients(meshes, shards_pair, case):
    jm, tm = meshes
    js, ts, n = shards_pair
    rng = np.random.default_rng(7)
    x = np.asarray(js.shard_features(
        rng.normal(size=(n, 4)).astype(np.float32)))
    ev = rng.normal(size=(P, js.e_max)).astype(np.float32) + 2.0
    cot = rng.normal(size=(P, js.n_max, 4)).astype(np.float32)
    if case.startswith("copy_u"):
        mean = case.endswith("mean")
        fj = lambda x: jd.dist_copy_u_sum(jm, js, x, mean=mean)  # noqa: E731
        ft = lambda x: td.dist_copy_u_sum(tm, ts, x, mean=mean)  # noqa: E731
        args = (x,)
    else:
        op = case.split("_")[0]
        if case.endswith("_ev"):
            fj = lambda x, e: jd.dist_spmm(jm, js, x, e, reduce_op=op)  # noqa
            ft = lambda x, e: td.dist_spmm(tm, ts, x, e, reduce_op=op)  # noqa
            args = (x, ev)
        else:
            fj = lambda x: jd.dist_spmm(jm, js, x, reduce_op=op)  # noqa
            ft = lambda x: td.dist_spmm(tm, ts, x, reduce_op=op)  # noqa
            args = (x,)
    oj, ot, gj, gt = _grads(fj, ft, args, args, cot)
    close(ot, oj, case)
    for i, (a, b) in enumerate(zip(gt, gj)):
        close(a, b, f"{case} grad {i}")
    with pytest.raises(dt.DGLError):
        td.dist_spmm(tm, ts, torch.from_numpy(np.array(x)), reduce_op="prod")


def test_delayed_aggregation(meshes, shards_pair):
    """First call on zero state: the local-only sum, and the returned
    state is the fresh halo; the second call on it equals the fresh sum."""
    jm, tm = meshes
    js, ts, n = shards_pair
    x = np.asarray(js.shard_features(np.random.default_rng(8).normal(
        size=(n, 4)).astype(np.float32)))
    jstate = jds.init_halo_state(jm, js, 4)
    tstate = td.init_halo_state(tm, ts, 4)
    assert tuple(tstate.shape) == tuple(jstate.shape)
    jo, jst = jds.dist_copy_u_sum_delayed(jm, js, x, jstate,
                                                   mean=True)
    to, tst = td.dist_copy_u_sum_delayed(tm, ts, torch.from_numpy(np.array(x)),
                                         tstate, mean=True)
    close(to, jo, "delayed out")
    close(tst, jst, "delayed state")
    exact(tst, np.asarray(td.halo_exchange(
        tm, torch.from_numpy(np.array(x)), ts.send_idx, ts.send_mask)))
    xt = torch.from_numpy(np.array(x))
    to2, _ = td.dist_copy_u_sum_delayed(tm, ts, xt, tst, mean=True)
    close(to2, td.dist_copy_u_sum(tm, ts, xt, mean=True))


@pytest.mark.parametrize("variant", ["plain", "weighted", "delayed"])
def test_dist_hetero_copy_u_sum(meshes, hetero, variant):
    jm, tm = meshes
    jg, tg, assign = hetero
    js = jd.build_hetero_shards(jg, assign, P)
    ts = td.build_hetero_shards(tg, assign, P)
    rng = np.random.default_rng(9)
    feats = {nt: rng.normal(size=(jg.num_nodes(nt), 8)).astype(np.float32)
             for nt in jg.ntypes}
    xj = js.shard_features(feats)
    nts = list(jg.ntypes)
    ew = {cet: rng.normal(size=(jg.num_edges(cet),)).astype(np.float32)
          for cet in jg.canonical_etypes}
    cots = {nt: rng.normal(size=(P, js.n_max[nt], 8)).astype(np.float32)
            for nt in nts}
    cets = list(jg.canonical_etypes)

    def jfn(*xs):
        x = dict(zip(nts, xs[:len(nts)]))
        kw = {}
        if variant == "weighted":
            kw["eweights"] = dict(zip(cets, xs[len(nts):]))
        if variant == "delayed":
            st = jd.init_hetero_halo_state(jm, js, {nt: 8 for nt in nts})
            out, st = jd.dist_hetero_copy_u_sum_delayed(jm, js, x, st,
                                                        mean=True)
            out, _ = jd.dist_hetero_copy_u_sum_delayed(jm, js, x, st,
                                                       mean=True)
        else:
            out = jd.dist_hetero_copy_u_sum(jm, js, x, **kw)
        return tuple(out[nt] for nt in nts)

    def tfn(*xs):
        x = dict(zip(nts, xs[:len(nts)]))
        kw = {}
        if variant == "weighted":
            kw["eweights"] = dict(zip(cets, xs[len(nts):]))
        if variant == "delayed":
            st = td.init_hetero_halo_state(tm, ts, {nt: 8 for nt in nts})
            out, st = td.dist_hetero_copy_u_sum_delayed(tm, ts, x, st,
                                                        mean=True)
            out, _ = td.dist_hetero_copy_u_sum_delayed(tm, ts, x, st,
                                                       mean=True)
        else:
            out = td.dist_hetero_copy_u_sum(tm, ts, x, **kw)
        return tuple(out[nt] for nt in nts)

    args = [np.asarray(xj[nt]) for nt in nts]
    if variant == "weighted":
        args += [np.asarray(js.shard_edge_data(c, ew[c])) for c in cets]
    out_j, vjp = jax.vjp(jax.jit(jfn), *[jnp.asarray(a) for a in args])
    g_j = jax.jit(vjp)(tuple(jnp.asarray(cots[nt]) for nt in nts))
    targs = [torch.from_numpy(np.array(a)).requires_grad_(True)
             for a in args]
    out_t = tfn(*targs)
    live = [i for i, o in enumerate(out_t) if o.requires_grad]
    g_t = torch.autograd.grad([out_t[i] for i in live], targs,
                              [torch.from_numpy(cots[nts[i]]) for i in live],
                              allow_unused=True)
    for nt, a, b in zip(nts, out_t, out_j):
        close(a, b, f"{variant} {nt}")
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        close(torch.zeros_like(targs[i]) if a is None else a, b,
              f"{variant} grad {i}")


def test_sparse_all_to_all_pull_and_push(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(10)
    n, rows_max, B, F = 50, 7, 6, 3
    ranges = np.minimum(np.arange(P + 1) * rows_max, n)
    table = rng.normal(size=(P, rows_max, F)).astype(np.float32)
    ids = rng.integers(0, n, (P, B))
    ref = jax.jit(lambda t: jd.sparse_all_to_all_pull(jm, ranges, t, ids))(
        table)
    got = td.sparse_all_to_all_pull(tm, ranges, torch.from_numpy(table),
                                    torch.from_numpy(ids))
    exact(got, np.asarray(ref), "pull")
    flat = table.reshape(P * rows_max, F)
    exact(got, flat[ids], "pull against the table")
    cot = rng.normal(size=(P, B, F)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda t: jnp.sum(
        jd.sparse_all_to_all_pull(jm, ranges, t, ids) * cot)))(table)
    tt = torch.from_numpy(table).requires_grad_(True)
    (td.sparse_all_to_all_pull(tm, ranges, tt, torch.from_numpy(ids))
     * torch.from_numpy(cot)).sum().backward()
    close(tt.grad, jg, "pull grad")
    # the pull's gradient is the push of the cotangent
    push = td.sparse_all_to_all_push(tm, ranges, torch.from_numpy(cot),
                                     torch.from_numpy(ids), rows_max)
    close(push, jax.jit(lambda c: jd.sparse_all_to_all_push(
        jm, ranges, c, ids, rows_max))(cot))
    close(push, tt.grad)


def test_mesh_collectives_and_byte_counts():
    m = tpar.create_mesh((4,), ("gp",), device="cpu")
    assert m.one_process and m.parts("gp") == 4 and m.shape == {"gp": 4}
    exact(m.axis_index("gp"), np.arange(4))
    x = torch.arange(4 * 4 * 3, dtype=torch.float32).reshape(4, 4, 3)
    y = m.all_to_all(x)
    exact(y, np.asarray(x).transpose(1, 0, 2))
    assert m.comm_bytes == {"int": 0, "float": 4 * 3 * 4}
    m.all_to_all(x.to(torch.int32))
    assert m.comm_bytes["int"] == 4 * 3 * 4
    m.reset_comm_bytes()
    s = m.psum(torch.ones(4, 2))
    exact(s, np.full((4, 2), 4.0))
    exact(m.pmean(torch.ones(4, 2)), np.ones((4, 2)))
    with pytest.raises(ValueError):
        m.all_to_all(torch.zeros(3, 4))
    m2 = tpar.create_mesh((2, -1), ("dp", "tp"), devices=8, device="cpu")
    assert m2.shape == {"dp": 2, "tp": 4} and m2.size == 8
    assert tpar.create_mesh(devices=3, device="cpu").shape == {"dp": 3,
                                                               "tp": 1}
    with pytest.raises(ValueError):
        tpar.create_mesh((3,), ("gp",), devices=4, device="cpu")
    assert tpar.MeshAxes().gp == jpar.MeshAxes().gp == "gp"


def test_every_reference_name_exists():
    """Every name of ``dgl_tpu.distributed.__all__`` and
    ``dgl_tpu.parallel.__all__`` (and ``param_shardings``) in the port, and
    none raises naming A11."""
    missing = [n for n in jd.__all__ if not hasattr(td, n)]
    missing += [n for n in jpar.__all__ + ["param_shardings"]
                if not hasattr(tpar, n)]
    assert not missing, missing
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for d in ("distributed", "parallel", "graphbolt"):
        for name in os.listdir(os.path.join(root, "dgl_tpu_torch", d)):
            if name.endswith(".py"):
                with open(os.path.join(root, "dgl_tpu_torch", d, name)) as f:
                    assert not re.search(r"A11", f.read()), name


def test_dist_tensor_embedding_and_sparse_optimisers(meshes):
    from dgl_tpu_torch.nn import sparse_emb

    jm, tm = meshes
    jt = jd.DistTensor((10, 3), name="t", mesh=jm)
    tt = td.DistTensor((10, 3), name="t", mesh=tm)
    assert tt.shape == jt.shape == (10, 3) and len(tt) == 10
    assert tuple(tt.data.shape) == tuple(jt.data.shape) == (16, 3)
    tt[np.array([1, 4])] = np.ones((2, 3), np.float32)
    jt[np.array([1, 4])] = np.ones((2, 3), np.float32)
    exact(tt.data, np.asarray(jt.data))
    for opt, jopt, kw in (("SparseAdam", jd.optim.SparseAdam,
                           dict(lr=0.01)),
                          ("SparseAdagrad", jd.optim.SparseAdagrad,
                           dict(lr=0.05))):
        je = jd.DistEmbedding(20, 4, mesh=jm, seed=3)
        te = td.DistEmbedding(20, 4, mesh=tm, seed=3, device="cpu")
        exact(te.data, np.asarray(je.data))
        jo, to = jopt([je], **kw), getattr(td.optim, opt)([te], **kw)
        plain = te.data.clone()
        init = (sparse_emb.sparse_adam_init if opt == "SparseAdam"
                else sparse_emb.sparse_adagrad_init)(plain)
        update = (sparse_emb.sparse_adam_update if opt == "SparseAdam"
                  else sparse_emb.sparse_adagrad_update)
        rng = np.random.default_rng(11)
        for _ in range(3):
            ids = rng.integers(0, 20, 6)
            g = rng.normal(size=(6, 4)).astype(np.float32)
            jo.step([(ids, g)])
            to.step([(torch.from_numpy(ids), torch.from_numpy(g))])
            plain, init = update(plain, init, torch.from_numpy(ids),
                                 torch.from_numpy(g), **kw)
        close(te.data, je.data, opt)
        close(te.data, plain, f"{opt} against the non-distributed one")
        exact(te(np.array([0, 3])), np_of(te.data)[[0, 3]])
    with pytest.raises(TypeError):
        td.optim.SparseAdam([tt])


def test_kvstore_policies_and_id_map():
    book_j = jd.RangePartitionBook(np.array([0, 4, 10]), 2,
                                   meta={"edge_ranges": [0, 7, 20]})
    book_t = td.RangePartitionBook(np.array([0, 4, 10]), 2,
                                   meta={"edge_ranges": [0, 7, 20]})
    ids = np.array([0, 3, 4, 9])
    for cls in ("NodePartitionPolicy", "EdgePartitionPolicy"):
        pj, pt = getattr(jd, cls)(book_j), getattr(td, cls)(book_t)
        assert pj.policy_str == pt.policy_str
        exact(pt.to_partid(ids), pj.to_partid(ids))
        exact(pt.to_local(torch.from_numpy(ids)), pj.to_local(ids))
        assert pt.get_part_size() == pj.get_part_size()
        assert pt.get_size() == pj.get_size()
    with pytest.raises(ValueError):
        td.EdgePartitionPolicy(td.RangePartitionBook([0, 1], 1))
    for is_node, et in ((True, "paper"), (False, ("a", "r", "b"))):
        hj = jd.HeteroDataName(is_node, et, "feat")
        ht = td.HeteroDataName(is_node, et, "feat")
        assert str(ht) == str(hj)
        back = td.parse_hetero_data_name(str(ht))
        assert back.get_type() == et and back.is_node() == is_node
    ranges = {"a": np.array([[0, 3], [5, 8]]), "b": np.array([[3, 5],
                                                               [8, 12]])}
    q = np.arange(12)
    for got, ref in zip(td.IdMap(ranges)(q), jd.IdMap(ranges)(q)):
        exact(got, ref)
    srv_j, srv_t = jd.KVServer(0), td.KVServer(0)
    cj, ct = jd.KVClient(srv_j), td.KVClient(srv_t)
    for c in (cj, ct):
        c.init_data("x", (6, 2), np.float32)
        c.push("x", np.array([1, 4]), np.full((2, 2), 3.0, np.float32))
    ct.push("x", torch.tensor([2]), torch.full((1, 2), 5.0))
    cj.push("x", np.array([2]), np.full((1, 2), 5.0, np.float32))
    exact(ct.pull("x", torch.tensor([1, 2, 3])),
          cj.pull("x", np.array([1, 2, 3])))
    for c in (cj, ct):
        c.register_push_handler(
            "x", lambda d, n, i, v: d[n].__setitem__(i, d[n][i] + v))
        c.register_pull_handler("x", lambda d, n, i: d[n][i] * 2)
        c.push("x", np.array([1]), np.ones((1, 2), np.float32))
    exact(ct.pull("x", np.array([1])), cj.pull("x", np.array([1])))
    assert ct.data_name_list() == cj.data_name_list() == ["x"]
    ct.delete_data("x")
    assert ct.data_name_list() == []
    with pytest.raises(td.DistConnectError):
        td.KVClient(None)


def test_role_registry_and_host_utilities(tmp_path):
    p = tmp_path / "ip.txt"
    p.write_text("10.0.0.1 30050\n\n10.0.0.2\n")
    assert td.read_ip_config(str(p)) == jd.read_ip_config(str(p))
    kv = td.init_kvstore(role="trainer")
    assert td.get_kvstore() is kv and td.get_role() == "trainer"
    td.close_kvstore()
    assert td.get_kvstore() is None
    td.init_role("default")
    assert td.get_trainer_rank() == 0 and td.get_num_trainers() == 1
    assert td.get_global_rank() == 0
    assert "127.0.0.1" in td.local_ip4_addr_list()
    ip, port = td.get_local_usable_addr().split(":")
    assert int(port) > 0 and ip
    outs = [np.zeros(2)]
    td.alltoall(outs, [np.ones(2)])
    exact(outs[0], np.ones(2))
    assert td.alltoallv is not None and td.alltoall_cpu is td.alltoall


def test_custom_pool_orders_results():
    pool = td.CustomPool(3)
    try:
        pool.set_collate_fn(lambda items: sum(items), "a")
        pool.set_collate_fn(lambda items: -sum(items), "b")
        for i in range(5):
            pool.submit_task("a", i, [i, 1])
            pool.submit_task("b", i, [i])
        assert [pool.get_result("a") for _ in range(5)] == [1, 2, 3, 4, 5]
        assert [pool.get_result("b") for _ in range(5)] == [0, -1, -2, -3,
                                                            -4]
        pool.set_collate_fn(lambda items: 1 / 0, "c")
        pool.submit_task("c", 0, [1])
        with pytest.raises(ZeroDivisionError):
            pool.get_result("c")
    finally:
        pool.close()
        pool.join()
    assert td.MpCommand.FINALIZE_POOL.value == jd.MpCommand.FINALIZE_POOL.value


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """One graph partitioned into 2 parts by both packages (the same
    random assignment), with node and edge features."""
    from dgl_tpu_torch.base import EID

    rng = np.random.default_rng(12)
    n, e = 40, 160
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    feat = rng.normal(size=(n, 3)).astype(np.float32)
    jg = dgl_tpu.graph((src, dst), num_nodes=n)
    tg = dt.graph((src, dst), num_nodes=n, device="cpu")
    jg.ndata["feat"] = jnp.asarray(feat)
    tg.ndata["feat"] = torch.from_numpy(feat)
    parts = rng.integers(0, 2, n)
    dirs = {}
    for side, m, g in (("jax", jd, jg), ("torch", td, tg)):
        d = str(tmp_path_factory.mktemp(f"parts_{side}"))
        m.partition_graph(g, "g", 2, d, parts=parts)
        dirs[side] = d
    return dirs, n


def test_dist_graph_and_graph_services(partitioned):
    from dgl_tpu_torch.base import EID

    dirs, n = partitioned
    for rank in (0, 1):
        jgr = jd.DistGraph(dirs["jax"], part_id=rank)
        tgr = td.DistGraph(dirs["torch"], part_id=rank, device="cpu")
        assert tgr.num_nodes() == jgr.num_nodes() == n
        # the reference's num_edges reads a dict key off the book's
        # metadata() list and raises; the port reads the book's count
        assert tgr.num_edges() == 160 and tgr.rank == rank
        with pytest.raises(AttributeError):
            jgr.num_edges()
        exact(tgr.ndata["feat"], np.asarray(jgr.ndata["feat"]))
        book = tgr.get_partition_book()
        lo, hi = int(book._ranges[rank]), int(book._ranges[rank + 1])
        seeds = np.arange(lo, hi)[:4]
        sj = jgr.sample_neighbors(seeds, 3, seed=5)
        st = td.sample_neighbors(tgr, torch.from_numpy(seeds), 3, seed=5)
        for a, b in zip(st.edges(), sj.edges()):
            exact(a, np.asarray(b))
        exact(st.edata[EID], np.asarray(sj.edata[EID]))
        with pytest.raises(dt.DGLError):
            tgr.sample_neighbors(np.array([hi % n if hi < n else 0]), 2)
        owned = np.arange(lo, hi)
        exact(td.in_degrees(tgr, owned), jd.in_degrees(jgr, owned))
        exact(td.out_degrees(tgr, owned), jd.out_degrees(jgr, owned))
        eids = np.asarray(sj.edata[EID])
        for a, b in zip(td.find_edges(tgr, eids), jd.find_edges(jgr, eids)):
            exact(a, b)
        nf_t, ef_t = td.load_partition_feats(dirs["torch"], rank,
                                             device="cpu")
        nf_j, _ = jd.load_partition_feats(dirs["jax"], rank)
        assert set(nf_t) == set(nf_j)
        for k in nf_j:
            exact(nf_t[k], np.asarray(nf_j[k]), k)
    exact(td.node_split(torch.arange(11) % 3 == 0, book, rank=1),
          jd.node_split(np.arange(11) % 3 == 0, book, rank=1))
    exact(td.edge_split(np.arange(7), book, rank=0),
          jd.edge_split(np.arange(7), book, rank=0))
    with pytest.raises(dt.DGLError):
        td.node_split(np.arange(4), book, rank=5)
    merged = td.merge_graphs([(np.array([0, 1]), np.array([2, 3]),
                               np.array([5, 6])),
                              (np.array([4]), np.array([0]), np.array([7]))],
                             n, exclude_edges=[6], device="cpu")
    ref = jd.merge_graphs([(np.array([0, 1]), np.array([2, 3]),
                            np.array([5, 6])),
                           (np.array([4]), np.array([0]), np.array([7]))],
                          n, exclude_edges=[6])
    for a, b in zip(merged.edges(), ref.edges()):
        exact(a, np.asarray(b))
    exact(merged.edata[EID], np.asarray(ref.edata[EID]))
    outs = td.dgl_partition_to_graphbolt(dirs["torch"], n_jobs=2)
    refs = jd.dgl_partition_to_graphbolt(dirs["jax"])
    for o, r in zip(outs, refs):
        a, b = np.load(o), np.load(r)
        for k in b.files:
            exact(a[k], b[k], k)
    target = {"x": np.zeros((4, 2))}
    td.default_push_handler(target, "x", torch.tensor([1]), torch.ones(1, 2))
    exact(td.default_pull_handler(target, "x", np.array([1, 0])),
          [[1.0, 1.0], [0.0, 0.0]])
    assert td.ServerState(partition_book=book).partition_book is book
    td.exit_client()  # no process group: a no-op


def test_dist_graph_server_and_data_views(partitioned):
    dirs, n = partitioned
    srv = td.DistGraphServer(0, part_config=dirs["torch"], graph_name="t19",
                             device="cpu")
    try:
        name = srv.shared_memory_name
        assert name is not None
        fused = dt.graphbolt.load_from_shared_memory(name)
        ref = jd.DistGraphServer(0, part_config=dirs["jax"],
                                 disable_shared_mem=True)
        exact(fused.csc_indptr,
              dt.graphbolt.from_dglgraph(srv.local_partition).csc_indptr)
        key = [k for k in srv.kvstore.data_store if k.endswith("feat")][0]
        exact(srv.kvstore.pull(key, np.arange(3)),
              ref.kvstore.pull(key, np.arange(3)))
    finally:
        srv.shutdown()
    tgr = td.DistGraph(dirs["torch"], part_id=0, device="cpu")
    view = td.NodeDataView(tgr)
    view["h"] = torch.zeros(3)
    assert "h" in view and len(view) == len(tgr.ndata)
    del view["h"]
    ev = td.EdgeDataView(tgr)
    ev["w"] = torch.ones(2)
    assert "w" in td.HeteroEdgeView(tgr)[None].data
    assert "feat" in td.HeteroNodeView(tgr)["_N"].data
    assert td.PlaceHolder is not None


# ---------------------------------------------------------------------------
# dryrun phase 1: the dp x tp data-parallel step
# ---------------------------------------------------------------------------


def _phase1_reference(rng, B, N, E, VOCAB, in_feats, hidden, classes):
    import optax
    from dgl_tpu.models import GraphSAGE

    graphs = [dgl_tpu.graph((rng.integers(0, N, E), rng.integers(0, N, E)),
                            num_nodes=N) for _ in range(B)]
    mi = max(r.max_in_degree for g in graphs for r in g._relations.values())
    mo = max(r.max_out_degree for g in graphs for r in g._relations.values())
    for g in graphs:
        for r in g._relations.values():
            r.max_in_degree, r.max_out_degree = mi, mo
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *graphs)
    node_ids = rng.integers(0, VOCAB, (B, N)).astype(np.int32)
    labels = rng.integers(0, classes, (B, N)).astype(np.int32)
    model = GraphSAGE(in_feats, hidden, classes, num_layers=2)
    params = {"model": model.init(jax.random.PRNGKey(0), graphs[0],
                                  jnp.zeros((N, in_feats))),
              "embedding": jnp.asarray(rng.normal(size=(VOCAB, in_feats)),
                                       jnp.float32)}
    return graphs, batched, node_ids, labels, model, params


def test_dryrun_phase1_dp_tp_step():
    """dryrun phase 1 at its small shapes (dp 4 x tp 2): the reference's
    ``sharded_train_step`` over its mesh against the port's over a
    one-process mesh, weights carried by ``from_flax_params``: the loss
    and every updated parameter at 1e-5."""
    import optax
    from dgl_tpu_torch.models import GraphSAGE
    from dgl_tpu_torch.params import from_flax_params
    from jax.sharding import PartitionSpec as JP

    rng = np.random.default_rng(0)
    dp, tp = 4, 2
    B, N, E, VOCAB, fin, hid, cls = dp, 64, 256, 128, 32, 64, 8
    graphs, batched, node_ids, labels, jmodel, params = _phase1_reference(
        rng, B, N, E, VOCAB, fin, hid, cls)
    p0 = jax.tree_util.tree_map(np.asarray, params)
    rules = {r"embedding": JP("tp", None),
             r"sage0.*fc_neigh.*kernel": JP(None, "tp"),
             r"sage1.*fc_self.*kernel": JP("tp", None)}
    jmesh = jpar.create_mesh((dp, tp), ("dp", "tp"),
                             devices=jax.devices()[:8])
    jparams = jpar.spmd.param_shardings(jmesh, params, rules)
    opt = optax.adam(1e-3)
    st = jpar.replicate(jmesh, opt.init(jparams))

    def jloss(params, batch):
        g, ids, y = batch

        def one(g, ids_g, y_g):
            x = params["embedding"][ids_g]
            return optax.softmax_cross_entropy_with_integer_labels(
                jmodel.apply(params["model"], g, x), y_g).mean()

        return jax.vmap(one)(g, ids, y).mean()

    step = jpar.sharded_train_step(jmesh, jloss, opt, donate=False)
    batch = (jpar.shard_batch(jmesh, batched),
             jpar.shard_batch(jmesh, node_ids),
             jpar.shard_batch(jmesh, labels))
    new_params, _, jl = step(jparams, st, batch)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            # eval: the reference's apply is deterministic (no dropout)
            self.sage = GraphSAGE(fin, hid, cls, num_layers=2,
                                  device="cpu").eval()
            self.sage.load_state_dict(from_flax_params(p0["model"]))
            self.embedding = torch.nn.Parameter(torch.from_numpy(
                np.array(p0["embedding"])))

    tmesh = tpar.create_mesh((dp, tp), ("dp", "tp"), devices=8,
                             device="cpu")
    model = tpar.param_shardings(tmesh, Model(), {
        r"embedding": tpar.PartitionSpec("tp", None)})
    assert tmesh.param_specs["embedding"] == ("tp", None)
    topt = torch.optim.Adam(model.parameters(), lr=1e-3)
    tgraphs = [dt.graph(tuple(np.asarray(a) for a in g.edges()),
                        num_nodes=N, device="cpu") for g in graphs]

    def tloss(model, batch):
        gs, ids, y = batch
        losses = [torch.nn.functional.cross_entropy(
            model.sage(g, model.embedding[i.long()]), t.long())
            for g, i, t in zip(gs, ids, y)]
        return torch.stack(losses).mean()

    tstep = tpar.sharded_train_step(tmesh, tloss, topt)
    tl = tstep(model, tpar.shard_batch(tmesh, (tgraphs, node_ids, labels)))
    close(tl, jl, "loss")
    close(model.embedding, new_params["embedding"], "embedding")
    flat = jax.tree_util.tree_flatten_with_path(new_params["model"])[0]
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
           for path, v in flat}
    fresh = Model()
    fresh.sage.load_state_dict(from_flax_params(jax.tree_util.tree_map(
        np.asarray, new_params["model"])))
    for (name, a), (_, b) in zip(model.sage.named_parameters(),
                                 fresh.sage.named_parameters()):
        close(a, b, name)
    assert len(ref) == len(list(model.sage.parameters()))
