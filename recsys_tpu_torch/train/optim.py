"""TF-parity Adam over parameter trees (counterpart of
``recsys_tpu/train/optim.py``, Adam only).

``tf.train.AdamOptimizer`` keeps a single ε outside the bias correction:

    lr_t = lr · √(1−β2ᵗ) / (1−β1ᵗ)
    m ← β1·m + (1−β1)·g,   v ← β2·v + (1−β2)·g²,   p ← p − lr_t · m / (√v + ε)

which ``torch.optim.Adam`` (ε inside the bias-corrected denominator) does
not reproduce. The update is dense over every parameter, the embedding
tables included: rows no example touched still decay their moments and
move, as in the reference; a lazy (row-sparse) Adam would diverge from it
after the first step.

The state ``AdamState(count, mu, nu)`` mirrors the JAX one (``mu``/``nu``
are trees shaped like the parameters), so checkpoints and the converter see
the same structure.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from recsys_tpu_torch.core import tree as tree_util


class Optimizer(NamedTuple):
    init: Any
    update: Any   # update(grads, state, params) -> (params, state)


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar: steps taken
    mu: Any
    nu: Any


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """TF-parity Adam. ``update`` works IN PLACE, under ``torch.no_grad()``:
    it overwrites the parameter tensors, ``mu``, ``nu`` and ``count`` that it
    is given and returns the same objects. The bias correction is computed
    on the device from ``count``, so a step never waits for the host."""

    def init(params) -> AdamState:
        leaves = tree_util.leaves(params)
        device = leaves[0].device if leaves else "cpu"
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_util.tree_map(torch.zeros_like, params),
            nu=tree_util.tree_map(torch.zeros_like, params),
        )

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        state.count.add_(1)
        t = state.count.to(torch.float32)
        lr_t = learning_rate * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        for p, g, m, v in zip(tree_util.leaves(params),
                              tree_util.leaves(grads),
                              tree_util.leaves(state.mu),
                              tree_util.leaves(state.nu)):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr_t * m / (v.sqrt() + eps))
        return params, state

    return Optimizer(init, update)
