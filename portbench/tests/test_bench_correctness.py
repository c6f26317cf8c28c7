"""The comparison that decides ``correct`` fails what it must: each control
(the reference one precision step below the stated one, in the program's
place: TF32 linears, float8 rows, both) fails a limit of each cell, and so
does each fault a cell can have, planted under the harness's run, also
where it starts only after the warm-up steps; the program itself passes.
At a CPU size; the controls also on the card (marked ``gpu``)."""
import pytest
import torch

from portbench import check, control, harness
from portbench.builders import System
from portbench.reference.common import CONTROLS
from portbench.tests.conftest import cells, tiny_cell


def _control_readings(name, device, seed=2**33 + 1):
    r = tiny_cell(name)
    post = {}
    res = harness.run_cell(r, seed, 0.2, False, device, post=post)
    assert res["correct"], (name, res["checks"])
    return r, dict(control.reference_readings(r, seed, device, post))


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
def test_control_fails_a_limit_of_every_cell(device, request):
    if device == "cuda":
        request.getfixturevalue("card")
    for name in cells():
        r, got = _control_readings(name, device)
        for kind in CONTROLS:
            correct, failed, _ = check.verdict(got[kind], r["limits"])
            assert not correct and failed >= 1, (name, kind, got[kind])


@pytest.mark.parametrize("name", cells())
def test_tf32_alone_is_not_correct(name):
    """The linears in TF32, the rows as stated: what a change that turns
    TF32 on would give, judged as a run judges it."""
    r, got = _control_readings(name, "cpu", seed=2**35 + 7)
    assert not check.verdict(got["tf32"], r["limits"])[0], got["tf32"]


def test_unchanged_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    res = harness.run_cell(tiny_cell("sage_arxiv.train"), 21, 0.2, False,
                           "cpu")
    assert not res["correct"]
    assert res["checks"]["median_change_gap"]["value"] > 0.5


def test_half_batch_is_not_correct(monkeypatch):
    real = harness.masked_loss

    def half(logits, y, mask):
        keep = mask.clone()
        on = torch.nonzero(keep).flatten()
        keep[on[::2]] = 0
        return real(logits, y, keep)

    monkeypatch.setattr(harness, "masked_loss", half)
    for name in ("sage_arxiv.train", "rgcn_mag.train"):
        res = harness.run_cell(tiny_cell(name), 22, 0.2, False, "cpu")
        assert not res["correct"], name
        assert res["checks"]["first_loss_gap"]["value"] > \
            res["checks"]["first_loss_gap"]["limit"]


def test_altered_answer_is_not_correct(monkeypatch):
    from portbench.builders import sage

    real = sage.build

    def altered(*a, **k):
        s = real(*a, **k)

        def forward():
            out = s.forward()
            out[3] = -out[3]
            return out
        return System(s.model, forward, s.labels, s.train_mask,
                      s.row_order, s.plans)

    monkeypatch.setattr(sage, "build", altered)
    res = harness.run_cell(tiny_cell("sage_arxiv.infer"), 23, 0.2, False,
                           "cpu")
    assert not res["correct"]
    assert control.summarise([{"kind": "program", "numbers": {"x": 1.0}},
                              {"kind": "control", "numbers": {"x": 3.0}}]
                             ) == {"x": {"program_max": 1.0,
                                         "control_min": 3.0}}


def test_step_past_the_window_is_compared(monkeypatch):
    """Faults that start only after the three compared steps (a path that
    changes after warm-up) are caught by the step past the window: an
    optimizer that stops updating, and a loss over half the batch."""
    real_step = torch.optim.Adam.step
    calls = {"n": 0}

    def stops(self, *a, **k):
        calls["n"] += 1
        if calls["n"] <= 3:
            return real_step(self, *a, **k)
    monkeypatch.setattr(torch.optim.Adam, "step", stops)
    res = harness.run_cell(tiny_cell("sage_arxiv.train"), 24, 0.2, False,
                           "cpu")
    assert not res["correct"]
    assert res["checks"]["window_change_gap"]["value"] > 0.5
    monkeypatch.setattr(torch.optim.Adam, "step", real_step)

    real_loss, seen = harness.masked_loss, {"n": 0}

    def halves_later(logits, y, mask):
        seen["n"] += 1
        if seen["n"] > 3:
            mask = mask.clone()
            mask[torch.nonzero(mask).flatten()[::2]] = 0
        return real_loss(logits, y, mask)
    monkeypatch.setattr(harness, "masked_loss", halves_later)
    res = harness.run_cell(tiny_cell("rgcn_mag.train"), 25, 0.2, False,
                           "cpu")
    assert not res["correct"]
    assert res["checks"]["first_loss_gap"]["value"] <= \
        res["checks"]["first_loss_gap"]["limit"]
    assert res["checks"]["window_loss_gap"]["value"] > \
        res["checks"]["window_loss_gap"]["limit"]
