"""Optimizers over parameter trees (counterpart of
``recsys_tpu/train/optim.py``): TF-parity Adam and FTRL-proximal, both
updating in place, and `for_model`, the optimizer a model declares.

``tf.train.AdamOptimizer`` keeps a single ε outside the bias correction:

    lr_t = lr · √(1−β2ᵗ) / (1−β1ᵗ)
    m ← β1·m + (1−β1)·g,   v ← β2·v + (1−β2)·g²,   p ← p − lr_t · m / (√v + ε)

which ``torch.optim.Adam`` (ε inside the bias-corrected denominator) does
not reproduce. The update is dense over every parameter, the embedding
tables included: rows no example touched still decay their moments and
move, as in the reference; a lazy (row-sparse) Adam would diverge from it
after the first step.

The learning rate may be a schedule: a function ``lr(t)`` of the 1-based
float32 step ``t``, a tensor on the device computed from ``state.count``
(`cosine_decay`), so that a step captured once in a CUDA graph reads the
step it replays and never the host.

The states ``AdamState(count, mu, nu)`` and ``FtrlState(z, n)`` mirror the
JAX ones (their trees are shaped like the parameters), so checkpoints and
the converter see the same structure.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.ops.adam_update import adam_update


class Optimizer(NamedTuple):
    init: Any
    update: Any   # update(grads, state, params) -> (params, state)


class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar: steps taken
    mu: Any
    nu: Any


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """TF-parity Adam. ``learning_rate`` is a float or a schedule ``lr(t)``
    of the 1-based float32 step tensor (`cosine_decay`); ``weight_decay``
    adds decoupled (AdamW-style) decay ``lr · weight_decay · p`` with the
    scheduled lr and the parameter before the step. ``update`` works IN
    PLACE, under ``torch.no_grad()``: it overwrites the parameter tensors,
    ``mu``, ``nu`` and ``count`` that it is given and returns the same
    objects. The bias correction and the schedule are computed on the
    device from ``count``, so a step never waits for the host; the
    elementwise update of every leaf is `ops.adam_update.adam_update`, one
    CUDA kernel launch over all leaves on the card."""

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
        lr = learning_rate(t) if callable(learning_rate) else learning_rate
        lr_t = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        adam_update(tree_util.leaves(params), tree_util.leaves(grads),
                    tree_util.leaves(state.mu), tree_util.leaves(state.nu),
                    lr_t, lr * weight_decay if weight_decay else None,
                    b1, b2, eps)
        return params, state

    return Optimizer(init, update)


def cosine_decay(peak_lr: float, total_steps: int, warmup_steps: int = 0,
                 floor: float = 0.0):
    """``lr(t)``: linear warm-up to ``peak_lr`` over ``warmup_steps``, then a
    cosine decay to ``floor · peak_lr`` at ``total_steps``, as
    ``recsys_tpu/train/optim.py`` computes it in float32. ``t`` is the
    optimizer's float32 step tensor; the result is a tensor on its device,
    built from ``torch.where``, ``torch.clamp`` and ``torch.cos`` only, so a
    captured step's replays each read their own step."""
    total = max(total_steps, 1)
    span = max(total - warmup_steps, 1)
    warm_div = max(warmup_steps, 1)

    def lr(t: torch.Tensor) -> torch.Tensor:
        # Python scalars enter each op as float32 operands, as the JAX
        # package's weakly typed constants do; no tensor is made here
        warm = t * peak_lr / warm_div
        frac = torch.clamp((t - warmup_steps) / span, 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(t < warmup_steps, warm, cos * peak_lr)

    return lr


class FtrlState(NamedTuple):
    z: Any   # per-weight z accumulator
    n: Any   # per-weight sum of squared gradients


def ftrl(alpha: float = 0.1, beta: float = 1.0, l1: float = 1.0,
         l2: float = 1.0) -> Optimizer:
    """FTRL-proximal, dense over every parameter (ftrl/ftrl.py:153-181).
    The parameters are the lazy weights derived from (z, n):

        σ = (√(n + g²) − √n) / α,   z ← z + g − σ·w,   n ← n + g²
        w = (sign(z)·l1 − z) / ((β + √n)/α + l2),  0 where |z| ≤ l1

    ``update`` works IN PLACE, under ``torch.no_grad()``, like `adam`: it
    overwrites the parameters, ``z`` and ``n`` and returns the same
    objects."""

    def init(params) -> FtrlState:
        return FtrlState(z=tree_util.tree_map(torch.zeros_like, params),
                         n=tree_util.tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(grads, state: FtrlState, params):
        for w, g, z, n in zip(tree_util.leaves(params),
                              tree_util.leaves(grads),
                              tree_util.leaves(state.z),
                              tree_util.leaves(state.n)):
            n_new = n + g * g
            z.copy_(z + g - (n_new.sqrt() - n.sqrt()) / alpha * w)
            n.copy_(n_new)
            lazy = (torch.sign(z) * l1 - z) / ((beta + n.sqrt()) / alpha + l2)
            w.copy_(torch.where(z.abs() <= l1, torch.zeros_like(lazy), lazy))
        return params, state

    return Optimizer(init, update)


def for_model(model_meta: dict, learning_rate: float) -> Optimizer:
    """The optimizer a model declares in ``Model.meta['optimizer']``: FTRL
    for the wide model (the reference's LinearClassifier is FTRL-backed,
    with TF's default l1 = l2 = 0: ``alpha=learning_rate``), TF-parity
    Adam otherwise."""
    if model_meta.get("optimizer") == "ftrl":
        return ftrl(alpha=learning_rate, l1=0.0, l2=0.0)
    return adam(learning_rate)
