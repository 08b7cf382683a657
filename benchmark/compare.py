"""The numbers that decide ``correct`` for a training cell, and the verdict.

Set-up drives the port's train state through its first three steps by the
window's own K-step call (one step a call). The reference follows the same
three steps from the same weights on the same rows (`reference`). The
numbers below are read on every run (`gaps`); those that the cell's limits
file (``benchmark/limits/<cell>.json``) names are compared, each against
its own limit:

- ``loss_gap``: |program − reference| / |reference| of the first step's
  loss (the largest over the three steps is reported beside, as
  ``loss_gap.steps``);
- ``grad_gap``: the first gradient as Adam got it, worked out from its first
  moments after one step (μ₁ = (1 − β₁)·g): for each leaf of the port's
  parameter tree |‖g_prog‖ − ‖g_ref‖| / max(‖g_ref‖, the median leaf's
  ‖g_ref‖), and of those the median leaf's;
- ``change_gap``: the change of the parameters over the three steps, leaf by
  leaf the same way, the median leaf's. Leaves whose reference gradient is
  under a thousandth of the median leaf's are left out: round-off alone
  moves them under Adam;
- ``grad_gap.<group>`` and ``change_gap.<group>``: the worst leaf of each
  group of leaves, a group being the leaves under one top-level key of the
  parameter tree (``tables``: the embedding tables that the gathers and the
  segment sums serve; ``cin``: the CIN filters of K3f and K3b; ``dnn``,
  ``final`` and the others of the model); a group none of whose leaves
  moves reads 0;
- ``change_gap.whole``: the change of every moving leaf taken as one
  vector, which the tables' millions of elements dominate.

The training cells compare ``loss_gap``, ``grad_gap``, ``change_gap``,
``grad_gap.tables``, ``change_gap.tables`` and ``change_gap.whole``, and
xDeepFM's also ``grad_gap.cin`` and ``change_gap.cin``.

Why the first step's loss and the median leaf over the whole tree, and not
every step's loss and the worst leaf of it: a pre-activation within
float32's rounding of a ReLU's kink falls on either side in two float32
sums of another order, so one example's gradient through one unit is in one
side's sum and not in the other's; through batch norm's backward that
reaches the leaves below it, and Adam's first steps, about lr·sign(g) an
element, turn it into whole steps of the elements whose gradient is near 0,
which the later steps' losses carry. The worst leaf of the MLP
(``grad_gap.worst``, ``change_gap.worst``) and the later losses then swing
with the seed on both sides alike: the float32 reference against a float64
one reads as the port does (``benchmark/control.py``, ``PERF.md``). The
worst leaves of the tables and of the CIN, and the whole change, hold to
account the leaves that the median leaf, one of the MLP's, does not see;
they swing less, since a flip moves a small share of a table's norm, and
their limits stand on their own readings.
"""

from __future__ import annotations

import math
import statistics


from benchmark.models import criteo

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's takes no part in the change
QUIET_GRAD = 1e-3


def leaf_norms(tree) -> dict[str, float]:
    """{leaf path: its float64 norm} of a tree of tensors."""
    return {criteo.path_name(p): float(t.detach().double().norm())
            for p, t in criteo.paths(tree)}


def tree_sub(a, b):
    if isinstance(a, dict):
        return {k: tree_sub(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [tree_sub(x, y) for x, y in zip(a, b, strict=True)]
    return a.detach() - b.detach()


def reference_readings(config: dict, result: dict, weights: dict,
                       template) -> dict:
    """The reference's losses and per-leaf norms of its first gradient and
    of its change, in the port's leaves (`criteo.pack` is linear)."""
    return {"losses": result["losses"],
            "grad": leaf_norms(criteo.pack(config, result["grad0"],
                                           template)),
            "change": leaf_norms(criteo.pack(
                config, tree_sub(result["params"], weights), template))}


def group(leaf: str) -> str:
    """The group of a leaf path: its top-level key."""
    return leaf.split("/", 1)[0]


def _leaf_gaps(prog: dict, ref: dict, leaves) -> dict[str, float]:
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves}


def gaps(prog: dict, ref: dict) -> dict:
    """{name: (value, what it was read from)} of every number the module's
    docstring names; the cell's limits choose those compared (`verdict`)."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's and the reference's leaves differ: "
                         f"{sorted(set(prog['grad']) ^ set(ref['grad']))}")
    losses = [abs(p - r) / abs(r)
              for p, r in zip(prog["losses"], ref["losses"], strict=True)]
    step = max(range(len(losses)), key=lambda i: losses[i])
    g_med = statistics.median(ref["grad"].values())
    moving = [k for k in ref["grad"] if ref["grad"][k] >= QUIET_GRAD * g_med]
    out = {"loss_gap": (losses[0], "step 0"),
           "loss_gap.steps": (losses[step], f"step {step}")}
    for name, leaves in (("grad", list(ref["grad"])), ("change", moving)):
        by_leaf = _leaf_gaps(prog[name], ref[name], leaves)
        worst = max(by_leaf, key=by_leaf.get)
        out[f"{name}_gap"] = (statistics.median(by_leaf.values()),
                              f"median of {len(leaves)} leaves")
        out[f"{name}_gap.worst"] = (by_leaf[worst], worst)
        for g in sorted({group(k) for k in ref["grad"]}):
            mine = [k for k in leaves if group(k) == g]
            worst = max(mine, key=by_leaf.get, default=None)
            out[f"{name}_gap.{g}"] = ((by_leaf[worst], worst) if mine else
                                      (0.0, "no leaf of the group moves"))
    whole = [math.sqrt(sum(side["change"][k] ** 2 for k in moving))
             for side in (prog, ref)]
    out["change_gap.whole"] = (abs(whole[0] - whole[1]) / whole[1],
                               "all moving leaves as one")
    return out


def compared(limits: dict) -> list[str]:
    """The numbers a limits file holds a limit of (its keys that do not
    start with ``_``), in its order."""
    return [k for k in limits if not k.startswith("_")]


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names within its limit, {name:
    {'value', 'limit', 'at'}}). A number the readings lack fails."""
    checks = {}
    ok = True
    for name in compared(limits):
        if name not in found:
            found = {**found, name: (float("nan"), "not read")}
        value, at = found[name]
        limit = limits[name]["limit"]
        # a NaN compares false: it fails
        ok = ok and value <= limit
        checks[name] = {"value": value, "limit": limit, "at": at}
    return ok, checks
