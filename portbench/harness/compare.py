"""The comparison that decides ``correct`` for a training cell.

The readings of the first steps, each taken on the program and on the
plain reference from the same weights and batches:

* ``loss``: the largest relative gap of a step's loss;
* ``logits1`` (where both sides give the first step's logits): the norm
  of their difference over the reference's norm, over the whole batch;
* ``grad``: the first gradient as the optimizer gets it, by the worst
  leaf: the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change``: the change of each leaf over the steps, by the same rule,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).

A cell's limits name which of these it holds (and any others its
driver adds, such as ``data``); each reading must be at or under its
limit.
"""

from __future__ import annotations

import statistics

QUIET_SHARE = 1e-3


def worst_leaf_gap(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if not names:
        return 0.0
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def training(prog: dict, ref: dict) -> dict:
    """``{'loss', 'grad', 'change'}`` (and ``'logits1'``) of two
    readings of the first steps (each ``{'losses', 'grad', 'change'}``,
    and ``'logits'``)."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["losses"], ref["losses"], strict=True))
    grads = ref["grad"]
    med = statistics.median(grads.values())
    moving = [n for n in ref["change"]
              if n not in grads or grads[n] >= QUIET_SHARE * med]
    out = {"loss": loss,
           "grad": worst_leaf_gap(prog["grad"], grads, grads),
           "change": worst_leaf_gap(prog["change"], ref["change"], moving)}
    if ref.get("logits") is not None:
        p, r = prog.get("logits"), ref["logits"].float()
        out["logits1"] = (1.0 if p is None or p.shape != r.shape else
                          float((p.float() - r).norm() / r.norm()))
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: [number, limit]})``: every limited number at
    or under its limit (a number that is missing or not finite fails)."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        shown[name] = [value, limit]
    return ok, shown
