"""Differentiable collectives over one mesh axis (the port's counterparts of
``lax.all_to_all``, ``lax.all_gather(tiled=True)`` and ``lax.psum`` inside
``shard_map``).

Each is a `torch.autograd.Function` over the plain ``torch.distributed``
call, and its backward is the JAX transpose:

- `all_to_all` ↔ `all_to_all`;
- `all_gather` (tiled along dim 0) ↔ reduce-scatter with a sum;
- `psum` ↔ `psum`.

So a loss that is replicated over an axis (every member computes the same
value) gets, through any of them, gradients E× too large on the far side,
as in JAX; ``spmd.normalize_model_replication`` divides them back. Every
call works on contiguous tensors with equal splits along dim 0, over the
process group of an `Axis`.

`recording` lists every collective issued through this module (and the
SPMD step's gradient all-reduce, `all_reduce_`) while it is open: its
operation, type and shape, forward and backward calls alike. That is the
exchange contract read from the program that runs
(``tools/bench_scaling.py``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

# torch 2.13 renamed the two tensor-in, tensor-out collectives and deprecated
# the old names; older releases have only the old ones
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


#: the lists of the open `recording` blocks
_recordings: list[list[dict]] = []
_recording_lock = threading.Lock()


@contextlib.contextmanager
def recording():
    """A list that every collective issued in this process while the block
    runs appends itself to, in order, as ``{"op", "dtype", "shape",
    "bytes"}`` of the tensor it sends (autograd's backward calls too, from
    whatever thread runs them)."""
    calls: list[dict] = []
    with _recording_lock:
        _recordings.append(calls)
    try:
        yield calls
    finally:
        with _recording_lock:
            _recordings.remove(calls)


def _record(op: str, x: torch.Tensor) -> None:
    if not _recordings:
        return
    entry = {"op": op, "dtype": str(x.dtype).removeprefix("torch."),
             "shape": tuple(x.shape), "bytes": x.numel() * x.element_size()}
    with _recording_lock:
        for calls in _recordings:
            calls.append(entry)


class Axis(NamedTuple):
    """One axis of the mesh as this rank sees it: the process group of the
    members that share this rank's other coordinate, their count, and this
    rank's index among them (its coordinate on the axis)."""

    group: Any
    size: int
    index: int


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _record("all-to-all", x)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        _record("all-to-all", g)
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group = group
        _record("all-gather", x)
        out = x.new_empty((size * x.shape[0], *x.shape[1:]))
        _all_gather_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        _record("reduce-scatter", g)
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),
                           *g.shape[1:]))
        _reduce_scatter_single(out, g, group=ctx.group)
        return out, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _record("all-reduce", x)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        _record("all-reduce", g)
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` [E, ...]: block j goes to member j, and ``out[i]`` is the block
    member i sent here (``lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    return _AllToAll.apply(x, axis.group)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` [n, ...] of every member, concatenated in member order →
    [E·n, ...] (``lax.all_gather(x, axis, tiled=True)``)."""
    return _AllGather.apply(x, axis.group, axis.size)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Σ of ``x`` over the members (``lax.psum``)."""
    return _Psum.apply(x, axis.group)


def all_reduce_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the members in place, outside autograd (the SPMD
    step's one all-reduce of its gradients, loss and BN stats) → ``x``."""
    _record("all-reduce", x)
    dist.all_reduce(x, group=axis.group)
    return x
