"""The plain reference of a training cell's first steps: the model of the
configuration (``benchmark/models/<model>.py``), the mean sigmoid
cross-entropy, autograd's gradients and TF's Adam, in float32 with TF32 off,
on the benchmark's weights and dataset.

It works out again what the port derives: each step's batch indices and
dropout masks come from a generator on the port's device type seeded as the
port seeds its train state's generator before that step
(`draws.step_seed`), drawn in the port's order (the indices, then one mask a
dense layer), so the same kernels give the same bits.

``precision='fp64'`` computes in float64: a witness of what float32's
rounding alone does to the numbers compared. ``precision='tf32'`` is the
control: every matrix product, forward and
backward, rounds its operands to TF32 (a 10-bit mantissa) and sums in
float32, as the card's TF32 tensor cores do. ``fault`` plants a fault in
the reference put in the program's place: ``'half_batch'`` takes the mean
loss over the first half of each batch only.

Plain PyTorch: imports nothing of the port.
"""

from __future__ import annotations

import importlib
import math

import torch

from benchmark import draws


def model_module(config: dict):
    """``benchmark/models/<config['model']>.py``."""
    return importlib.import_module(f"benchmark.models.{config['model']}")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (8-bit exponent, 10-bit
    mantissa), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).t(), to_tf32(a).t() @ g


def matmul(precision: str):
    if precision in ("fp32", "fp64"):
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example sigmoid cross-entropy in TF's form
    (``tf.nn.sigmoid_cross_entropy_with_logits``, which the source trains
    with): relu(x) − x·y + log(1 + e^−|x|). Its gradient at a logit of
    exactly 0 is −y, as relu's and abs's are 0 there; xDeepFM gives such
    logits wherever its three ReLU branches are all 0 and the final bias
    is still 0."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def _leaves(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def batch_draws(config: dict, traffic: dict, seed: int, step: int,
                n_rows: int, device):
    """(indices [B], dropout masks) of step ``step`` as the port draws them
    in a run of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.step_seed(seed, step))
    b = traffic["batch"]
    idx = torch.empty((b,), dtype=torch.int64, device=device)
    idx.random_(0, n_rows, generator=gen)
    keep = 1.0 - config["dropout"]
    masks = [torch.rand((b, h), generator=gen, device=device) < keep
             for h in config["deep_layers"]]
    return idx, masks


def train_steps(config: dict, traffic: dict, weights: dict,
                data: dict[str, torch.Tensor], seed: int, steps: int, *,
                precision: str = "fp32", fault: str | None = None) -> dict:
    """Run ``steps`` training steps from ``weights`` (a tree of the
    reference's layout, left unchanged) → {'losses': [each step's loss],
    'grad0': the first step's gradient tree, 'params': the weights after
    the steps}."""
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    mod = model_module(config)
    mm = matmul(precision)
    dtype = torch.float64 if precision == "fp64" else torch.float32
    opt = config["optimizer"]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    params = [p.detach().to(dtype, copy=True) for p in _leaves(weights)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    n_rows = data["label"].shape[0]
    device = data["label"].device
    losses, grad0 = [], None
    for step in range(steps):
        idx, masks = batch_draws(config, traffic, seed, step, n_rows, device)
        live = [p.requires_grad_() for p in params]
        tree = _rebuild(weights, iter(live))
        logits = mod.forward(config, tree, data["ids"][idx],
                             data["dense"][idx].to(dtype), masks, mm)
        per = sigmoid_ce(logits, data["label"][idx].to(dtype))
        loss = per[:per.shape[0] // 2].mean() if fault else per.mean()
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        if step == 0:
            grad0 = _rebuild(weights, iter([g.detach() for g in grads]))
        t = step + 1
        lr_t = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        with torch.no_grad():
            params = [p.detach() for p in live]
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr_t * m / (v.sqrt() + eps))
    return {"losses": losses, "grad0": grad0,
            "params": _rebuild(weights, iter(params))}
