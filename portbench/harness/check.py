"""The numbers that decide ``correct`` for a training cell, and their
verdict.

A training cell's set-up runs the check's chunks: the first two chunks of
``scan_steps`` steps through the window's own entry, the first eager, the
second captured and replayed, from the weights the benchmark made. It keeps
what they give: each step's loss, the first step's logits and the
gradients the optimizer's first step got (after the clip), the parameters
after the last step, and the state of the program's generator of masks.
The reference follows the same steps from the same weights, inputs and
seed. Compared, by the worst leaf where leaves are compared:

* ``loss_gap``: the largest ``|loss_p - loss_r| / |loss_r|`` of the steps;
* ``grad_gap``: the largest ``|‖g_p‖ - ‖g_r‖|`` of a leaf's first
  gradient, over the larger of the reference's norm of that leaf and of
  the median leaf;
* ``change_gap``: the same of each leaf's change over the steps,
  ``‖p_last - p_0‖``, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone);
* ``loss1_gap``, ``grad_gap_median``, ``change_gap_median``: the first
  step's loss alone, and the median leaf's gaps, steadier from seed to
  seed where one small leaf's rounding sets the worst;
* ``grad_diff_median``: the median leaf's ``‖g_p - g_r‖ / ‖g_r‖`` of the
  first gradient. A norm averages out rounding that is unbiased element
  by element, so a precision below the configuration's can leave every
  norm within the sound runs' spread; the difference does not;
* ``logits_diff``: ``‖z_p - z_r‖ / ‖z_r‖`` of the first step's logits (the
  train-mode forward, masks and all), element by element: rounding in the
  forward, which a flip of a ReLU or of a gradient's sign near nought does
  not swamp as it does the gradients;
* ``draws_mismatch``: 1 where the program's generator of masks does not
  stand where the reference's does after the same steps (a chunk that
  reused a step's draws, or a replay that did not advance them), else 0.

Which of them a cell compares, and against what limit, is in
``portbench/checks/<cell>.json``; the rest are printed, not judged.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

# A leaf's gradient under this share of the median leaf's is nought to
# rounding: its change is not compared.
HELD_GRAD_SHARE = 1e-3


def _norm(t) -> float:
    return float(t.double().norm())


def _same_state(a, b) -> bool:
    return a is not None and b is not None and a.numel() == b.numel() and bool((a.cpu() == b.cpu()).all())


def training_numbers(program: Dict, reference: Dict, weights: Dict) -> Dict[str, float]:
    """``program`` and ``reference``: ``losses``, ``first_grad`` and
    ``params`` (by leaf name); ``weights``: the leaves the steps started
    from."""
    losses = [abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program["losses"], reference["losses"])]
    grads_r = {k: _norm(g) for k, g in reference["first_grad"].items()}
    # A leaf the optimizer holds no state for got no gradient from it.
    grads_p = {k: _norm(program["first_grad"][k]) if k in program["first_grad"] else 0.0 for k in grads_r}
    median_grad = statistics.median(grads_r.values())
    # The first gradient's difference, leaf by leaf, over the reference's.
    diffs = {k: (_norm(program["first_grad"][k].cpu() - reference["first_grad"][k].cpu()) / max(grads_r[k], 1e-30)
                 if k in program["first_grad"] else 1.0) for k in grads_r}
    grad_gaps = {k: abs(grads_p[k] - grads_r[k]) / max(grads_r[k], median_grad, 1e-30) for k in grads_r}
    counted = [k for k in grads_r if grads_r[k] >= HELD_GRAD_SHARE * median_grad]
    change_r = {k: _norm(reference["params"][k].cpu() - weights[k].cpu()) for k in counted}
    change_p = {k: _norm(program["params"][k].cpu() - weights[k].cpu()) for k in counted}
    median_change = statistics.median(change_r.values())
    change_gaps = {k: abs(change_p[k] - change_r[k]) / max(change_r[k], median_change, 1e-30) for k in counted}
    logits_p, logits_r = program.get("first_logits"), reference["first_logits"]
    logits_diff = (_norm(logits_p.reshape(logits_r.shape) - logits_r) / max(_norm(logits_r), 1e-30)
                   if logits_p is not None and logits_p.numel() == logits_r.numel() else 1.0)
    draws_mismatch = 0.0 if _same_state(program.get("draws_state"), reference.get("draws_state")) else 1.0
    worst_grad = max(grad_gaps, key=grad_gaps.get)
    worst_change = max(change_gaps, key=change_gaps.get)
    finite = all(map(math.isfinite, losses))
    return {
        "loss_gap": max(losses) if finite else math.inf,
        "loss1_gap": losses[0] if finite else math.inf,
        "grad_gap": grad_gaps[worst_grad],
        "grad_gap_median": statistics.median(grad_gaps.values()),
        "grad_diff_median": statistics.median(diffs.values()),
        "logits_diff": logits_diff,
        "change_gap": change_gaps[worst_change],
        "change_gap_median": statistics.median(change_gaps.values()),
        "draws_mismatch": draws_mismatch,
        "_worst_grad_leaf": worst_grad,
        "_worst_change_leaf": worst_change,
        "_leaves_not_compared": sorted(set(grads_r) - set(counted)),
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``(correct, [(name, number, limit)])`` over the numbers the cell has
    limits for: correct where the cell has limits and every such number is
    finite and within its limit."""
    rows = [(name, float(numbers.get(name, math.inf)), float(limit)) for name, limit in limits.items()]
    ok = bool(rows) and all(math.isfinite(value) and value <= limit for _, value, limit in rows)
    return ok, rows
