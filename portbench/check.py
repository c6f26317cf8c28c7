"""How ``correct`` is decided: the program's readings against the plain
reference's, each number against its limit (``limits/<workload>.json``).

Training cells compare the first three steps, which the window's own step
runs in set-up on the object the window then drives:

- ``first_loss_gap``: the first step's ``|loss - ref| / |ref|``;
- ``grad_gap``: the first gradient as Adam got it (its first moment after
  step 1 over ``1 - beta1``), by the worst leaf: ``| |g| - |g_ref| |``
  over the larger of ``|g_ref|`` and the median leaf's ``|g_ref|``;
- ``median_change_gap``: the parameters' change over the three steps,
  each leaf's gap as above, the median leaf's; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out (they
  move by round-off alone under Adam). The medians are over the leaves
  that the reference gives a gradient;

and one more step after the window (and the traced segment), through the
same call, against a reference step from a snapshot of the parameters,
Adam's moments and step count and the dropout generator taken just before
it, so that a path that changes after warm-up is compared too:

- ``window_loss_gap``, ``window_grad_gap`` (the gradient the step left in
  ``.grad``), ``window_change_gap`` (that step's change, median leaf),
  each as the first steps' numbers;
- ``dropout_replay``: 0 where the reference's replay of the dropout masks
  left the card's generator where the program's steps left it, after the
  first three steps and after the step past the window, else 1.

The later of the first steps' losses and the worst leaf's change are not
compared: under Adam a gradient element near 0 whose sign differs by
round-off moves its weight by twice the learning rate, so they swing from
seed to seed by orders of magnitude (``PERF.md`` gives the readings).
``detail`` keeps them.

Serving cells compare each forward kept from the window with the
reference's logits row by row: a node's gap is ``|P_i - R_i|`` over the
larger of ``|R_i|`` and the median node's ``|R|``.
``logits_median_row_gap`` is the median node's gap and
``logits_worst_row_gap`` the largest, each by the worst forward. The
median stays steady where a hub's bf16 row rounds the other way on one
side and moves the many nodes it reaches (the whole-matrix gap swung over
three orders of magnitude from seed to seed for that reason); the largest
catches one node's answer altered.
"""
from __future__ import annotations

import statistics

import torch

from .reference.common import Adam, masked_loss

STEPS = 3


def seed_dropout(seed: int, device) -> None:
    """Seed the generator that ``nn.Dropout`` draws from on ``device``."""
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def rng_state(device) -> torch.Tensor:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_rng_state()
    return torch.get_rng_state()


def set_rng_state(state, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_rng_state(state)
    else:
        torch.set_rng_state(state)


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(
        t.detach().float()))


def reference_train(fam, cfg: dict, inputs, weights: dict, row_order,
                    dropout_seed: int, prec, device, loss_mask=None) -> dict:
    """The reference's first three steps from the benchmark's weights:
    losses, the first gradient's norms, the change's norms, and the
    dropout generator's state after them. ``loss_mask`` replaces the
    train mask (a planted fault)."""
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    adam = Adam(params, cfg["lr"])
    mask = inputs.train_mask if loss_mask is None else loss_mask
    names = list(params)
    seed_dropout(dropout_seed, device)
    losses, first = [], None
    for k in range(STEPS):
        masks = fam.dropout_masks(cfg, inputs, row_order)
        loss = masked_loss(fam.forward(cfg, params, inputs, prec, masks),
                           inputs.labels, mask)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[n] for n in names], allow_unused=True)))
        if k == 0:
            first = {n: _norm(g) for n, g in grads.items()}
        adam.step(grads)
        losses.append(float(loss.detach()))
        del loss, grads, masks
    return {"losses": losses, "grad_norms": first,
            "change_norms": {n: _norm(params[n] - weights[n])
                             for n in names},
            "rng": rng_state(device)}


def program_train(step, opt, model, weights: dict, dropout_seed: int,
                  device) -> dict:
    """The program's first three steps through the window's own ``step``;
    the readings as ``reference_train`` gives them."""
    seed_dropout(dropout_seed, device)
    beta1 = opt.param_groups[0]["betas"][0]
    params = dict(model.named_parameters())
    losses, first = [], None
    for k in range(STEPS):
        losses.append(float(step()))
        if k == 0:
            first = {n: _norm(opt.state[p]["exp_avg"] / (1 - beta1))
                     if "exp_avg" in opt.state.get(p, {}) else 0.0
                     for n, p in params.items()}
    return {"losses": losses, "grad_norms": first,
            "change_norms": {n: _norm(p - weights[n])
                             for n, p in params.items()},
            "rng": rng_state(device)}


def program_step(step, opt, model, device) -> tuple:
    """One more step through the window's ``step``: ``(snapshot,
    readings)``. The snapshot holds what the step starts from (each
    parameter, Adam's moments, its step count, the dropout generator's
    state); the readings are the step's loss, the gradient it left in
    ``.grad`` and its change, as ``reference_step`` gives them."""
    params = dict(model.named_parameters())
    moments, counts = {}, set()
    for n, p in params.items():
        st = opt.state.get(p, {})
        if "exp_avg" in st:
            moments[n] = (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
            counts.add(int(st["step"]))
    if len(counts) > 1:
        raise RuntimeError(f"Adam's step counts differ by leaf: {counts}")
    snap = {"params": {n: p.detach().clone() for n, p in params.items()},
            "moments": moments, "t": counts.pop() if counts else 0,
            "rng": rng_state(device)}
    loss = float(step())
    return snap, {
        "losses": [loss],
        "grad_norms": {n: _norm(p.grad) for n, p in params.items()},
        "change_norms": {n: _norm(p - snap["params"][n])
                         for n, p in params.items()},
        "rng": rng_state(device)}


def reference_step(fam, cfg: dict, inputs, snap: dict, row_order, prec,
                   device, loss_mask=None) -> dict:
    """The reference's step from ``snap`` (``program_step``'s snapshot):
    the dropout masks drawn from its generator state, Adam seeded with
    its moments and step count."""
    params = {n: v.clone().requires_grad_(True)
              for n, v in snap["params"].items()}
    adam = Adam(params, cfg["lr"])
    adam.t = snap["t"]
    for n, (m, v) in snap["moments"].items():
        adam.m[n], adam.v[n] = m.clone(), v.clone()
    names = list(params)
    mask = inputs.train_mask if loss_mask is None else loss_mask
    set_rng_state(snap["rng"], device)
    masks = fam.dropout_masks(cfg, inputs, row_order)
    loss = masked_loss(fam.forward(cfg, params, inputs, prec, masks),
                       inputs.labels, mask)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [params[n] for n in names], allow_unused=True)))
    adam.step(grads)
    return {"losses": [float(loss.detach())],
            "grad_norms": {n: _norm(g) for n, g in grads.items()},
            "change_norms": {n: _norm(params[n] - snap["params"][n])
                             for n in names},
            "rng": rng_state(device)}


def _leaf_gaps(got: dict, ref: dict, grads: dict) -> list:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (all of them when ``grads`` is
    ``ref`` itself, the gradient's own comparison)."""
    med_g = statistics.median([v for v in grads.values() if v > 0])
    keep = [n for n in ref if grads is ref or grads[n] >= 1e-3 * med_g]
    med = statistics.median([ref[n] for n in keep if ref[n] > 0])
    return [abs(got[n] - ref[n]) / max(ref[n], med) for n in keep]


def _loss_gap(got: dict, ref: dict, k: int = 0) -> float:
    a, b = got["losses"][k], ref["losses"][k]
    return abs(a - b) / abs(b)


def train_numbers(got: dict, ref: dict, got_w: dict, ref_w: dict,
                  detail: dict | None = None) -> dict:
    """The numbers compared in a training cell: ``got`` / ``ref`` are the
    first three steps' readings, ``got_w`` / ``ref_w`` the step's past
    the window."""
    g, g_w = ref["grad_norms"], ref_w["grad_norms"]
    change = _leaf_gaps(got["change_norms"], ref["change_norms"], g)
    if detail is not None:
        detail.update(loss_gaps=[_loss_gap(got, ref, k)
                                 for k in range(len(ref["losses"]))],
                      worst_change_gap=max(change))
    replayed = (torch.equal(got["rng"], ref["rng"])
                and torch.equal(got_w["rng"], ref_w["rng"]))
    return {
        "first_loss_gap": _loss_gap(got, ref),
        "grad_gap": max(_leaf_gaps(got["grad_norms"], g, g)),
        "median_change_gap": statistics.median(change),
        "window_loss_gap": _loss_gap(got_w, ref_w),
        "window_grad_gap": max(_leaf_gaps(got_w["grad_norms"], g_w, g_w)),
        "window_change_gap": statistics.median(_leaf_gaps(
            got_w["change_norms"], ref_w["change_norms"], g_w)),
        "dropout_replay": 0.0 if replayed else 1.0,
    }


def in_reference_order(t, row_order):
    if row_order is None:
        return t
    return torch.empty_like(t).index_copy_(0, row_order, t)


def logits_numbers(outputs, ref, row_order) -> dict:
    ref_norm = torch.linalg.vector_norm(ref, dim=1)
    scale = ref_norm.clamp(min=float(ref_norm.median()))
    med, worst = 0.0, 0.0
    for o in outputs:
        gap = torch.linalg.vector_norm(
            in_reference_order(o, row_order).float() - ref, dim=1) / scale
        med = max(med, float(gap.median()))
        worst = max(worst, float(gap.max()))
    return {"logits_median_row_gap": med, "logits_worst_row_gap": worst}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, failed, checks)``: each number beside its limit, the
    count over their limits; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    failed = sum(1 for c in checks.values()
                 if c["limit"] is None or not c["value"] <= c["limit"])
    return failed == 0, failed, checks
