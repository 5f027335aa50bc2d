"""What the train drivers record of a step and compare with the reference.

A train cell's set-up drives the one training object it then hands to the
window through its first ``REF_STEPS`` steps, through the window's own call
and feed.  It records each step's losses, the first gradient as the
optimizer got it (Adam's first moment after one step, which is the
gradient itself at β1 = 0) and, after the last of them, how far every leaf
(parameters, the EMA copy, buffers) has moved from the seeded state.  The
reference follows the same steps from the same inputs and records the same.
"""

from __future__ import annotations

import statistics

import numpy as np

import reference as ref

REF_STEPS = 3
# A leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the change.
STILL_GRAD = 1e-3


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator, as the training loops make it
    (a hash of the run's seed and the step)."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, step]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _leaves(nets: dict) -> dict:
    out = {}
    for tag, net in nets.items():
        for k, v in net.state_dict().items():
            if v.is_floating_point():
                out[f"{tag}.{k}"] = v
    return out


def first_grads(nets_opts: dict) -> dict:
    """‖Adam's first moment‖ of every parameter after one step: the
    gradient the optimizer got, which the moment equals at β1 = 0."""
    out = {}
    for tag, (net, opt) in nets_opts.items():
        if any(g["betas"][0] != 0 for g in opt.param_groups):
            raise ValueError("the first gradient is read from Adam's state only at beta1 0")
        for k, p in net.named_parameters():
            st = opt.state.get(p, {})
            out[f"{tag}.{k}"] = float(st["exp_avg"].norm()) if "exp_avg" in st else 0.0
    return out


def changes(nets: dict, start: dict) -> dict:
    """‖leaf − its seeded value‖ for every floating leaf of ``nets``
    (``{tag: module}``); ``start`` maps the same keys to the seeded values."""
    return {k: float((v.float() - start[k].float()).norm()) for k, v in _leaves(nets).items()}


def record_losses(metrics: dict, names) -> dict:
    return {n: float(metrics[n]) for n in names if n in metrics}


def compare(prog: dict, refr: dict, limits, scalars=()) -> list:
    """The cell's compared numbers, program against reference: ``loss_gap``,
    the worst loss gap over the steps (``_first``: the first step's; ``rel``:
    over |the reference's loss|); ``grad_gap``, the worst leaf's gap of
    first-gradient norms, and ``grad_gap_median``, the median leaf's;
    ``change_gap`` and ``change_gap_median``, the same of the change norms
    (still leaves left out); ``<scalar>_gap`` of each named scalar of the
    state.  Only those that ``limits`` names are compared (all, unbounded,
    where ``limits`` is None, as the readings for the limits are taken)."""
    def loss_gaps(steps, rel):
        return max(abs(a - refr["losses"][i][k]) / (max(abs(refr["losses"][i][k]), 1e-3)
                                                   if rel else 1.0)
                   for i in steps for k, a in prog["losses"][i].items())

    every = range(len(prog["losses"]))
    med = statistics.median(refr["grads"].values())
    still = {k for k, v in refr["grads"].items() if v < STILL_GRAD * med}
    moving = [k for k in refr["change"]
              if k not in still and not any(k == "E" + s[1:] for s in still if s[0] == "G")]
    values = {"loss_gap": loss_gaps(every, False), "loss_gap_first": loss_gaps([0], False),
              "loss_rel_gap": loss_gaps(every, True), "loss_rel_gap_first": loss_gaps([0], True)}
    where = {}
    for name, key, keys in (("grad_gap", "grads", None), ("change_gap", "change", moving)):
        gaps = ref.leaf_gaps(prog[key], refr[key], keys)
        worst = max(gaps, key=gaps.get)
        values[name], where[name] = gaps[worst], worst
        values[f"{name}_median"] = statistics.median(gaps.values())
    for s in scalars:
        values[f"{s}_gap"] = abs(prog["scalars"][s] - refr["scalars"][s])
    return ref.checks_of(values, limits, where)
