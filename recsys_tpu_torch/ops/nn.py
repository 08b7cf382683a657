"""Dense-tower primitives: dense / MLP / batch-norm / dropout.

Counterpart of ``recsys_tpu/ops/nn.py``, as plain functions on tensors over
dict parameter trees of the same structure, so a converted JAX tree drops
straight in:

- dense kernels are ``[in, out]`` and apply as ``x @ w + b`` (not
  ``nn.Linear``'s ``[out, in]``), so weights need no transpose;
- batch norm keeps the TF1 semantics of the reference, not
  ``nn.BatchNorm1d``'s defaults: epsilon 1e-3, moving-stat decay 0.99 and
  the biased batch variance for both the normalization and the moving stats;
- the tower order is dense → relu → BN → dropout.

Initializers take an explicit CPU ``torch.Generator`` and a ``device``:
values are drawn on the CPU, so one seed gives the same weights on any
device. They match the JAX package's distributions, not its numbers. On
the ``meta`` device they draw nothing and only give shapes (a template).
"""

from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]
State = dict[str, Any]

BN_MOMENTUM = 0.99
BN_EPS = 1e-3


# ---------------------------------------------------------------------------
# initializers (TF1-default parity)
# ---------------------------------------------------------------------------

def _host_empty(shape, device, dtype) -> torch.Tensor:
    """Uninitialized tensor to draw into: on the CPU, or on ``meta`` when
    the target is ``meta``."""
    host = "meta" if torch.device(device).type == "meta" else "cpu"
    return torch.empty(shape, dtype=dtype, device=host)


def glorot_uniform(gen: torch.Generator, shape, device,
                   dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    x = _host_empty(shape, device, dtype).uniform_(-limit, limit,
                                                   generator=gen)
    return x.to(device)


def truncated_normal(gen: torch.Generator, shape, stddev: float, device,
                     dtype=torch.float32) -> torch.Tensor:
    """N(0, stddev²) truncated at ±2 standard deviations."""
    x = _host_empty(shape, device, dtype)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * stddev).to(device)


def embedding_init(gen: torch.Generator, shape, device,
                   dtype=torch.float32) -> torch.Tensor:
    """tf.feature_column.embedding_column default:
    truncated_normal(stddev=1/sqrt(embedding_dim))."""
    return truncated_normal(gen, shape, 1.0 / math.sqrt(shape[-1]), device,
                            dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device,
               dtype=torch.float32) -> Params:
    return {
        "w": glorot_uniform(gen, (in_dim, out_dim), device, dtype),
        "b": torch.zeros((out_dim,), dtype=dtype, device=device),
    }


def dense(params: Params, x, activation=None) -> torch.Tensor:
    """``x @ w + b``. ``x`` may be a list/tuple of [B, d_i] pieces with
    Σd_i = in_dim: each piece meets its row slice of ``w`` and the partial
    products are summed — ``dense(concat(x))`` without the concat."""
    w = params["w"]
    if isinstance(x, (list, tuple)):
        y = None
        lo = 0
        for piece in x:
            d = piece.shape[-1]
            part = piece @ w[lo:lo + d]
            y = part if y is None else y + part
            lo += d
        y = y + params["b"]
    else:
        y = x @ w + params["b"]
    if activation is not None:
        y = activation(y)
    return y


# ---------------------------------------------------------------------------
# batch norm (train returns updated moving stats)
# ---------------------------------------------------------------------------

def bn_init(dim: int, device, dtype=torch.float32) -> tuple[Params, State]:
    params = {"scale": torch.ones((dim,), dtype=dtype, device=device),
              "offset": torch.zeros((dim,), dtype=dtype, device=device)}
    state = {"mean": torch.zeros((dim,), dtype=dtype, device=device),
             "var": torch.ones((dim,), dtype=dtype, device=device)}
    return params, state


def batch_norm(params: Params, state: State, x: torch.Tensor,
               train: bool) -> tuple[torch.Tensor, State]:
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        new_state = {
            "mean": BN_MOMENTUM * state["mean"] + (1 - BN_MOMENTUM) * mean,
            "var": BN_MOMENTUM * state["var"] + (1 - BN_MOMENTUM) * var,
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean) * inv * params["scale"] + params["offset"]
    return y, new_state


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: torch.Generator | None) -> torch.Tensor:
    if not train or rate <= 0.0:
        return x
    if gen is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=gen.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# MLP tower: [dense -> relu -> bn -> dropout] x N  (reference ordering)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, in_dim: int, layer_dims: tuple[int, ...],
             use_bn: bool, device,
             dtype=torch.float32) -> tuple[Params, State]:
    params: Params = {"layers": []}
    state: State = {"layers": []}
    d = in_dim
    for h in layer_dims:
        layer_p: Params = {"dense": dense_init(gen, d, h, device, dtype)}
        layer_s: State = {}
        if use_bn:
            layer_p["bn"], layer_s["bn"] = bn_init(h, device, dtype)
        params["layers"].append(layer_p)
        state["layers"].append(layer_s)
        d = h
    return params, state


def mlp_apply(params: Params, state: State, x, *, train: bool,
              dropout_rate: float = 0.0,
              gen: torch.Generator | None = None) -> tuple[torch.Tensor, State]:
    """Reference tower ordering: dense+relu, then BN, then dropout."""
    new_state: State = {"layers": []}
    h = x
    for i, layer_p in enumerate(params["layers"]):
        h = dense(layer_p["dense"], h, activation=torch.relu)
        layer_s = state["layers"][i] if state["layers"] else {}
        new_layer_s: State = {}
        if "bn" in layer_p:
            h, new_layer_s["bn"] = batch_norm(layer_p["bn"], layer_s["bn"], h,
                                              train)
        h = dropout(h, dropout_rate, train, gen)
        new_state["layers"].append(new_layer_s)
    return h, new_state
