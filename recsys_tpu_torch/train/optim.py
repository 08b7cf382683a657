"""Optimizers over parameter trees (counterpart of
``recsys_tpu/train/optim.py``): TF-parity Adam, FTRL-proximal and Adagrad
with row-wise accumulators on sparse tables, all updating in place, and
`for_model`, the optimizer a model declares.

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

`rowwise_adagrad` (DLRM's, which the JAX package has not) updates a table
whose gradient is sparse (`segment_sum.SparseRows`) over its touched rows
only, one accumulator a row; the other leaves take elementwise Adagrad.
Row-wise Adagrad leaves a row with a zero gradient exactly as it was, so
the sparse update is the dense one, row for row.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.ops.adam_update import adam_update
from recsys_tpu_torch.ops.rowwise_adagrad import rowwise_adagrad as \
    rowwise_update
from recsys_tpu_torch.ops.segment_sum import SparseRows


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


class AdagradState(NamedTuple):
    acc: Any   # per-weight sums of squared gradients; per row on a table


def rowwise_adagrad(learning_rate: float, rowwise: tuple[str, ...] = (),
                    eps: float = 1e-8) -> Optimizer:
    """Adagrad with a constant learning rate and accumulators starting at 0.
    The top-level leaves named in ``rowwise`` are tables [V, W] with one
    accumulator a row, updated from their sparse gradient by
    `ops.rowwise_adagrad.rowwise_adagrad`:

        a_r ← a_r + mean(g_r²),   w_r ← w_r − lr·g_r / (√a_r + ε)

    one CUDA launch a table over the touched rows on the card. Every other
    leaf takes elementwise Adagrad, ``a ← a + g²``, ``p ← p − lr·g / (√a +
    ε)``, in that order of operations, as PyTorch's multi-tensor operations
    over all of them. ``update`` works IN PLACE, under
    ``torch.no_grad()``, like `adam`."""

    def init(params) -> AdagradState:
        return AdagradState(acc={
            k: (torch.zeros(v.shape[:1], dtype=v.dtype, device=v.device)
                if k in rowwise else tree_util.tree_map(torch.zeros_like, v))
            for k, v in params.items()})

    @torch.no_grad()
    def update(grads, state: AdagradState, params):
        dense_p, dense_g, dense_a = [], [], []
        for k in sorted(params):
            if k in rowwise:
                if not isinstance(grads[k], SparseRows):
                    raise TypeError(f"rowwise_adagrad: the table {k!r} "
                                    "wants a sparse gradient")
                rowwise_update(params[k], state.acc[k], grads[k],
                               learning_rate, eps)
                continue
            dense_p += tree_util.leaves(params[k])
            dense_g += tree_util.leaves(grads[k])
            dense_a += tree_util.leaves(state.acc[k])
        if dense_p:
            torch._foreach_addcmul_(dense_a, dense_g, dense_g)
            den = torch._foreach_sqrt(dense_a)
            torch._foreach_add_(den, eps)
            step = torch._foreach_mul(dense_g, learning_rate)
            torch._foreach_div_(step, den)
            torch._foreach_sub_(dense_p, step)
        return params, state

    return Optimizer(init, update)


def for_model(model_meta: dict, learning_rate: float) -> Optimizer:
    """The optimizer a model declares in ``Model.meta['optimizer']``: FTRL
    for the wide model (the reference's LinearClassifier is FTRL-backed,
    with TF's default l1 = l2 = 0: ``alpha=learning_rate``), row-wise
    Adagrad for DLRM (its tables ``meta['sparse_tables']``), TF-parity
    Adam otherwise."""
    if model_meta.get("optimizer") == "ftrl":
        return ftrl(alpha=learning_rate, l1=0.0, l2=0.0)
    if model_meta.get("optimizer") == "rowwise_adagrad":
        return rowwise_adagrad(learning_rate,
                               tuple(model_meta.get("sparse_tables", ())))
    return adam(learning_rate)
