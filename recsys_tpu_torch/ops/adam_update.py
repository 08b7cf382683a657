"""Adam's update over a list of leaves, in place — the CUDA kernel's wrapper
and its plain version. The kernel replaces no TPU kernel (the JAX package
leaves Adam to XLA); ``csrc/adam_update.cu`` says why it was added, what
bounds it on the H100 and how its design answers.

    adam_update(params, grads, mu, nu, lr_t, lr_wd, b1, b2, eps)

    m ← b1·m + (1−b1)·g,   v ← b2·v + (1−b2)·g²,   p ← p − lr_t·m / (√v + ε)
    then, where ``lr_wd`` is not None, p ← p − lr_wd·p_old

for every leaf, p_old being the parameter before the step. ``lr_t`` is the
bias-corrected learning rate and ``lr_wd`` the scheduled learning rate
times the weight decay, both computed by `train.optim.adam` on the device.

For CUDA tensors one launch of the kernel covers up to `MAX_LEAVES` leaves
(a larger tree takes further launches); it computes each element with the
plain version's IEEE float32 operations in its order, so on the card the
two agree bitwise. For CPU tensors the wrapper takes the plain version,
`adam_update_reference`.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import F, I, LL, P

#: launches count under ``adam_update``, the leaves they covered under
#: ``adam_update.leaves`` (`cuda_build.launches`)
SOURCE = cuda_build.source(
    "adam_update.cu",
    adam_update=[I] + [ctypes.POINTER(LL)] * 5 + [P] * 2 + [F] * 5 + [P])
#: leaves one launch covers (``MAX_LEAVES`` of csrc/adam_update.cu)
MAX_LEAVES = 64


@torch.no_grad()
def adam_update_reference(params, grads, mu, nu, lr_t, lr_wd, b1: float,
                          b2: float, eps: float) -> None:
    """The plain version: PyTorch's elementwise operations, leaf by leaf."""
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        # the decay reads p before the step's write: (p − u) − lr·wd·p
        decay = lr_wd * p if lr_wd is not None else None
        p.sub_(lr_t * m / (v.sqrt() + eps))
        if decay is not None:
            p.sub_(decay)


def _check(params, grads, mu, nu) -> None:
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"adam_update: {len(params)} parameters, "
                         f"{len(grads)} gradients, {len(mu)} and {len(nu)} "
                         "moments")
    device = params[0].device if len(params) else None
    for i, leaf in enumerate(zip(params, grads, mu, nu)):
        for name, t in zip(("parameter", "gradient", "mu", "nu"), leaf):
            if t.dtype != torch.float32:
                raise TypeError(f"adam_update: {name} of leaf {i} is "
                                f"{t.dtype}, want float32")
            if not t.is_contiguous():
                raise ValueError(f"adam_update: {name} of leaf {i} is not "
                                 "contiguous")
            if t.device != device:
                raise ValueError(f"adam_update: {name} of leaf {i} on "
                                 f"{t.device}, leaf 0 on {device}")
        if len({tuple(t.shape) for t in leaf}) != 1:
            raise ValueError(f"adam_update: leaf {i}'s parameter, gradient, "
                             "mu and nu differ in shape: "
                             f"{[tuple(t.shape) for t in leaf]}")


def _device_scalar(x, name: str, device: torch.device) -> torch.Tensor:
    """``x`` as the float32 device scalar the kernel reads; a Python number
    is filled in on the card (no copy from the host, so it can be
    captured)."""
    if isinstance(x, numbers.Real):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.numel() == 1 and x.device == device):
        raise ValueError(f"adam_update: {name} must be a number or a "
                         f"float32 scalar on {device}, got {x!r}")
    return x


def adam_update(params, grads, mu, nu, lr_t, lr_wd, b1: float, b2: float,
                eps: float) -> None:
    """One Adam step over the lists of leaves ``params``, ``grads``, ``mu``
    and ``nu``, written into ``params``, ``mu`` and ``nu``. Every leaf is a
    contiguous float32 tensor on one device; a leaf's four tensors agree in
    shape. ``lr_wd`` is None without weight decay.

    CUDA tensors go through the kernel; the call raises if it cannot
    launch. CPU tensors go through `adam_update_reference`."""
    _check(params, grads, mu, nu)
    if not len(params):
        return
    device = params[0].device
    if device.type == "cpu":
        adam_update_reference(params, grads, mu, nu, lr_t, lr_wd, b1, b2,
                              eps)
        return
    if device.type != "cuda":
        raise ValueError(f"adam_update: no kernel for device {device}")
    lr_t = _device_scalar(lr_t, "lr_t", device)
    if lr_wd is not None:
        lr_wd = _device_scalar(lr_wd, "lr_wd", device)
    live = [i for i, p in enumerate(params) if p.numel()]
    if not live:
        return

    def addresses(leaves):
        return (ctypes.c_longlong * len(live))(
            *(leaves[i].data_ptr() for i in live))

    sizes = (ctypes.c_longlong * len(live))(*(params[i].numel() for i in live))
    stream = cuda_build.launch(
        SOURCE, "adam_update", device, len(live), addresses(params),
        addresses(grads), addresses(mu), addresses(nu), sizes,
        lr_t.data_ptr(), None if lr_wd is None else lr_wd.data_ptr(), b1,
        1 - b1, b2, 1 - b2, eps, n=-(-len(live) // MAX_LEAVES))
    cuda_build.count("adam_update.leaves", stream, len(live))
