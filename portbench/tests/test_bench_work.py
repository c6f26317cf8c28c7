"""The yardstick's arithmetic at tiny shapes against hand counts, and the
work model's aggregations against the calls the program makes."""
import pytest
import torch

from portbench import harness, inputs as inputs_mod, peaks, roofline, spec
from portbench.builders import cold_tail
from portbench.reference import rgcn, sage
from portbench.tests.conftest import tiny_cell

SAGE = {"in_channels": 4, "hidden_channels": 8, "out_channels": 3,
        "num_layers": 3}
HOMO = ("_N", "_E", "_N")


def test_sage_flops_by_hand():
    # layer 0 (4 -> 8, mean first): 2 linears of 2*10*4*8 = 640, sum 20*4
    # layer 1 (8 -> 8): 2 * 1280 + 20*8; layer 2 (8 -> 3, projects first):
    # 2 * 480 + 20*3. Training adds both weights' gradients, both input
    # gradients past layer 0, and the backward sums of layers 1 and 2
    infer = sage.work(SAGE, {"_N": 10}, {HOMO: 20}, "infer")
    train = sage.work(SAGE, {"_N": 10}, {HOMO: 20}, "train")
    assert infer["flops"] == (1280 + 80) + (2560 + 160) + (960 + 60)
    assert train["flops"] == (1360 + 1280) + (2720 + 2560 + 2560 + 160) + (
        1020 + 960 + 960 + 60)
    assert infer["aggs"] == [("_E", 4, "fwd"), ("_E", 8, "fwd"),
                             ("_E", 3, "fwd")]
    assert sorted(train["aggs"]) == sorted(infer["aggs"] + [
        ("_E", 8, "bwd"), ("_E", 3, "bwd")])


RGCN = {"in_channels": 4, "hidden_channels": 2, "out_channels": 3,
        "num_layers": 2,
        "graph": {"target": "p", "relations": [["p", "cites", "p", 6],
                                               ["a", "writes", "p", 7],
                                               ["a", "aff", "i", 3]]}}
RGCN_NODES = {"p": 5, "a": 4, "i": 2}
RGCN_EDGES = {("p", "cites", "p"): 6, ("a", "writes", "p"): 7,
              ("a", "aff", "i"): 3}


def test_rgcn_flops_by_hand():
    # layer 0 (4 -> 2, projects first): cites 2*5*4*2 + 6*2, writes and
    # aff 2*4*4*2 + 7*2 and + 3*2; layer 1 (2 -> 3) runs cites alone (a has
    # no input there): 6*2 + 2*5*2*3. Backward: layer 1's cites (weight,
    # input, sum), layer 0's cites and writes (weight, sum); aff reaches
    # no loss
    infer = rgcn.work(RGCN, RGCN_NODES, RGCN_EDGES, "infer")
    train = rgcn.work(RGCN, RGCN_NODES, RGCN_EDGES, "train")
    assert infer["flops"] == 92 + 78 + 70 + 72
    assert train["flops"] == 312 + (60 + 60 + 12) + (80 + 12) + (64 + 14)
    assert sorted(train["aggs"]) == sorted(infer["aggs"] + [
        ("cites", 2, "bwd"), ("cites", 2, "bwd"), ("writes", 2, "bwd")])


def test_b1_least_by_hand():
    tail = {"edges": 100, "rows": 40, "n_out": 50, "base": True, "elem": 2}
    p = peaks.Peaks(1000.0, 1000.0)
    # 4*100 index bytes + 40*8*2 row bytes + 50*8*4 out + the same base
    assert roofline.b1_least_seconds(tail, 8, p) == pytest.approx(4.24)
    tail["base"] = False
    assert roofline.b1_least_seconds(tail, 8, p) == pytest.approx(2.64)
    # operations bind where the rate of adds is the lower
    assert roofline.b1_least_seconds(tail, 8, peaks.Peaks(1e9, 1.0)) == 800
    assert roofline.b1_least_per_step(
        [("r", 8, "fwd"), ("r", 8, "bwd")],
        {"r": {"fwd": tail, "bwd": None}}, p) == pytest.approx(2.64)


def test_peaks_by_card_name():
    assert peaks.of("NVIDIA H100 80GB HBM3").f32_flops_per_s == 67e12
    assert peaks.of("NVIDIA H100 80GB HBM3").hbm_bytes_per_s == 3.35e12
    for other in ("cpu", "NVIDIA H100 PCIe", "NVIDIA H100 NVL"):
        with pytest.raises(RuntimeError):
            peaks.of(other)


@pytest.mark.parametrize("workload", ["sage_arxiv.train", "rgcn_mag.train",
                                      "sage_arxiv.infer"])
def test_work_model_matches_program_calls(workload, monkeypatch):
    """Each cold-tail sum the program makes in one step (or forward) is an
    aggregation of the work model, at its width and direction, and the
    plan's tails account for every cold edge."""
    from dgl_tpu_torch.ops import hub_spmm

    r = tiny_cell(workload)
    cfg = {**r["cfg"], "graph": spec.graph_spec(r)}
    fam = spec.reference(cfg["family"])
    inp, w, _ = inputs_mod.make(cfg["graph"],
                                fam.param_shapes(cfg), 5, "cpu")
    nodes, edges = dict(inp.num_nodes), inp.edge_counts()
    system = spec.builder(cfg["family"]).build(cfg, inp, w, "cpu")
    calls = []
    real = hub_spmm.shell_prefix_sum

    def counted(table, flat_idx, *a, **k):
        for rel, p in system.plans.items():
            for d, idx in (("fwd", p.shell_idx), ("bwd", p.rev_shell_idx)):
                if flat_idx is idx:
                    calls.append((rel, table.shape[1], d))
        return real(table, flat_idx, *a, **k)

    monkeypatch.setattr(hub_spmm, "shell_prefix_sum", counted)
    mode = r["mix"]["mode"]
    if mode == "train":
        loss = harness.masked_loss(system.forward(), system.labels,
                                   system.train_mask)
        loss.backward()
    else:
        with torch.no_grad():
            system.forward()
    # a direction without shell levels (all its sources hubs, as a
    # 43-node type under 128 hubs) makes no cold-tail sum
    want = [(rel, f, d) for rel, f, d in fam.work(cfg, nodes, edges,
                                                  mode)["aggs"]
            if cold_tail(system.plans[rel], d == "bwd") is not None]
    assert sorted(calls) == sorted(want)
    for rel, p in system.plans.items():
        res = p.res_dst
        n_res = 0 if res is None else int(res[3].sum())
        tail = cold_tail(p, False)
        assert (0 if tail is None else tail["edges"]) + n_res == p.num_cold
