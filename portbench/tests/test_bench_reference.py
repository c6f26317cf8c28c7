"""The plain references against the port's plain CPU path (graphs without
plans, exact f32 sums), and every cell's run on the CPU at a small size."""
import pytest
import torch

from portbench import check, harness, inputs as inputs_mod, spec
from portbench.reference.common import Precision
from portbench.tests.conftest import cells, tiny_cell


def _plain_program(cfg, inp, weights):
    """The port's model over graphs without plans: every sum through its
    plain f32 branch."""
    import dgl_tpu_torch as dt
    from dgl_tpu_torch.examples.rgcn_hetero import HeteroRGCN
    from dgl_tpu_torch.models import GraphSAGE

    from portbench.builders import load_weights

    gen = torch.Generator().manual_seed(0)
    if cfg["family"] == "sage":
        (src, dst), = inp.relations.values()
        g = dt.graph((src, dst), num_nodes=inp.num_nodes["_N"], device="cpu")
        model = GraphSAGE(cfg["in_channels"], cfg["hidden_channels"],
                          cfg["out_channels"], num_layers=cfg["num_layers"],
                          aggregator_type="mean", dropout=cfg["dropout"],
                          generator=gen, device="cpu").eval()
        x = inp.feats["_N"]

        def fwd():
            return model(g, x)
    else:
        g = dt.heterograph(dict(inp.relations), dict(inp.num_nodes),
                           device="cpu")
        model = HeteroRGCN(cfg["in_channels"], cfg["hidden_channels"],
                           cfg["out_channels"], tuple(g.etypes),
                           generator=gen, device="cpu")
        x = dict(inp.feats)

        def fwd():
            return model(g, x)[inp.target]
    load_weights(model, weights)
    return model, fwd


@pytest.mark.parametrize("workload", ["sage_arxiv.infer", "rgcn_mag.train"])
def test_reference_matches_plain_port_path(workload):
    r = tiny_cell(workload)
    cfg = {**r["cfg"], "graph": spec.graph_spec(r)}
    fam = spec.reference(cfg["family"])
    inp, w, _ = inputs_mod.make(cfg["graph"],
                                fam.param_shapes(cfg), 11, "cpu")
    model, fwd = _plain_program(cfg, inp, w)
    out = fwd()
    loss = harness.masked_loss(out, inp.labels, inp.train_mask)
    loss.backward()
    exact = Precision(torch.float32, "f32")
    params = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = fam.forward(cfg, params, inp, exact)
    ref_loss = harness.masked_loss(ref, inp.labels, inp.train_mask)
    ref_loss.backward()
    scale = ref.abs().max()
    assert (out - ref).abs().max() <= 1e-5 * scale
    for name, p in model.named_parameters():
        want = params[name].grad
        if want is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        assert (p.grad - want).abs().max() <= 1e-5 * want.abs().max(), name


def test_every_cell_correct_on_the_cpu():
    for name in cells():
        res = harness.run_cell(tiny_cell(name), 2**31 + 17, 0.3, False, "cpu")
        # each number within its limit (not bit-equal: where the program's
        # f32 sums and the reference's add in another order, a bf16 row can
        # round the other way, and a hub's row reaches many nodes)
        assert res["correct"], (name, res["checks"])
        assert res["attempted"] >= 1
        assert res["device"]["platform"] == "cpu"


def test_same_seed_same_inputs_other_seed_other_ids():
    r = tiny_cell("rgcn_mag.train")
    cfg = {**r["cfg"], "graph": spec.graph_spec(r)}
    fam = spec.reference("rgcn")
    make = lambda s: inputs_mod.make(  # noqa: E731
        cfg["graph"], fam.param_shapes(cfg), s, "cpu")
    a, wa, da = make(2**40 + 3)
    b, wb, db = make(2**40 + 3)
    c, _wc, _dc = make(2**40 + 4)
    for cet in a.relations:
        assert all(torch.equal(x, y) for x, y in zip(a.relations[cet],
                                                     b.relations[cet]))
        assert a.relations[cet][0].shape == c.relations[cet][0].shape
    assert all(torch.equal(wa[k], wb[k]) for k in wa) and da == db
    assert not torch.equal(a.relations[("paper", "cites", "paper")][0],
                           c.relations[("paper", "cites", "paper")][0])
    assert torch.equal(a.train_mask, b.train_mask)
    assert a.train_mask.sum() == c.train_mask.sum()


def test_rounded_sum_gradient_rounds_both_ways():
    from portbench.reference.common import rounded_sum

    t = torch.tensor([[1.0 + 2**-10], [3.0]], requires_grad=True)
    src, dst = torch.tensor([0, 1, 0]), torch.tensor([0, 0, 1])
    out = rounded_sum(t, src, dst, 2, Precision())
    assert out.tolist() == [[4.0], [1.0]]  # 1 + 2^-10 rounds to 1 in bf16
    out.backward(torch.tensor([[1.0 + 2**-10], [2.0]]))
    assert t.grad.tolist() == [[3.0], [1.0]]
    assert check.in_reference_order(torch.tensor([[5.0], [6.0]]),
                                    torch.tensor([1, 0])).tolist() == [
                                        [6.0], [5.0]]
