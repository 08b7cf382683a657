"""Offset-packed embedding tables (counterpart of
``recsys_tpu/embeddings/table.py``).

All fields of a table live in ONE row-major ``[V_pad, D+1]`` matrix: columns
``0..D-1`` are the embedding, column ``D`` the wide/linear weight, and a
batch of field-local ids is shifted by static per-field offsets into global
row ids and fetched with one gather. `table_gather` is every table read of
the port (the Criteo engines', the wide model's and DIN's): its forward is
the row gather of ``ops/row_gather.py``, its backward the segment sum of
``ops/segment_sum.py``; on the card both are hand-written CUDA kernels.
The wide model's per-row weight vector is read the same way, as a
``[V_pad, 1]`` view (`linear_sum`).

Multi-hot bags (DLRM's): `bag_sum` reads a fixed number of ids a field,
the fields' bags side by side, with one row gather, and sums each field's
span. A table too large for a dense gradient (26.5M rows on one card)
trains as a `SparseTable`: its bag's backward gives the touched rows' summed
gradients (`segment_sum.segment_sum_sparse`, the pooled gradient handed to
each id in the kernel) and nothing of the table's size, which the row-wise
optimizer applies (`optim.rowwise_adagrad`).

``V_pad`` stays a multiple of 1024, as in the JAX package, so a converted
JAX table and a port table have the same shape. The JAX package stores its
big table transposed (``[D+1, V_pad]``) for the TPU's lane tiling; the port
keeps rows contiguous, which is what a GPU gather wants, and ``convert.py``
transposes between the two.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from recsys_tpu_torch.core.config import EmbeddingConfig
from recsys_tpu_torch.ops import nn, row_gather, segment_sum
from recsys_tpu_torch.utils import profiling

#: Row-count multiple of every packed table (the JAX package's TILE_V).
ROW_MULTIPLE = 1024


def field_offsets(field_vocab_sizes: tuple[int, ...]) -> np.ndarray:
    """Static cumulative offsets turning field-local ids into packed rows."""
    return np.concatenate([[0], np.cumsum(field_vocab_sizes[:-1])]).astype(
        np.int32
    )


def pad_rows(total: int, multiple: int = ROW_MULTIPLE) -> int:
    return (total + multiple - 1) // multiple * multiple


def to_global_ids(ids: torch.Tensor, offsets) -> torch.Tensor:
    """[B, F] field-local → packed global row ids. ``offsets`` is a numpy
    array or, to send nothing from the host, a tensor already on ``ids``'s
    device."""
    return ids + torch.as_tensor(offsets, dtype=ids.dtype,
                                 device=ids.device)[None, :]


def linear_init(gen: torch.Generator, field_vocab_sizes: tuple[int, ...],
                device, dtype=torch.float32) -> dict:
    """Packed per-row linear weights (the indicator → dense(1) kernel
    rows): ``{'w': [V_pad] glorot_uniform over the virtual [V_pad, 1]
    kernel, 'b': 0}``."""
    v = pad_rows(sum(field_vocab_sizes))
    return {"w": nn.glorot_uniform(gen, (v, 1), device, dtype)[:, 0],
            "b": torch.zeros((), dtype=dtype, device=device)}


def linear_sum(params: dict, gids: torch.Tensor) -> torch.Tensor:
    """Wide term: Σ_f w[gid_f] + b → [B, 1]. ``w`` is read through
    `table_gather` on its ``[V_pad, 1]`` view, so on the card the forward
    is the row gather and the backward the segment sum at W = 1 (the JAX
    package takes a plain ``jnp.take``; the values are the same)."""
    w = table_gather(params["w"].view(-1, 1), gids)[..., 0]     # [B, F]
    return w.sum(dim=1, keepdim=True) + params["b"]


def fused_init(gen: torch.Generator, cfg: EmbeddingConfig,
               device) -> torch.Tensor:
    """[V_pad, D+1] packed table: cols 0..D-1 embedding (truncated-normal
    1/sqrt(D)), col D wide weight (glorot over the virtual [V, 1] kernel)."""
    v = pad_rows(cfg.total_vocab)
    dtype = getattr(torch, cfg.dtype)
    emb = nn.embedding_init(gen, (v, cfg.embedding_dim), device, dtype)
    wide = nn.glorot_uniform(gen, (v, 1), device, dtype)
    return torch.cat([emb, wide], dim=1)


class _TableGather(torch.autograd.Function):
    """Forward the rows from `row_gather.row_gather`; backward the dense
    ``[V, W]`` table gradient from `segment_sum.segment_sum` (on the card
    each is a CUDA kernel, on the CPU its plain version). The table is
    row-major, so the gradient lands in the storage layout as it is."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = table.shape[0]
        return row_gather.row_gather(table, flat_ids)

    @staticmethod
    def backward(ctx, d_rows):
        (flat_ids,) = ctx.saved_tensors
        return segment_sum.segment_sum(flat_ids, d_rows.contiguous(),
                                       ctx.num_rows), None


def table_gather(table: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Row-major gather: ``[V, W]`` table + int64 global ids of any shape →
    rows ``[*gids.shape, W]``, differentiable in the table."""
    rows = _TableGather.apply(table, gids.reshape(-1))
    return rows.reshape(*gids.shape, table.shape[1])


# ---------------------------------------------------------------------------
# multi-hot bags and the sparse gradient
# ---------------------------------------------------------------------------

class SparseTable:
    """A table as one training step reads it when its gradient is sparse
    (``train_state.loss_and_grads``, for the leaves a model names in
    ``meta['sparse_tables']``): ``weight`` the table, ``token`` an empty
    tensor that requires grad and ties the step's bag to autograd, and
    ``grad`` the `segment_sum.SparseRows` that the bag's backward leaves."""

    def __init__(self, weight: torch.Tensor):
        self.weight = weight.detach()
        self.token = torch.empty((0,), dtype=weight.dtype,
                                 device=weight.device, requires_grad=True)
        self.grad: segment_sum.SparseRows | None = None


def pool_bags(rows: torch.Tensor, bag_sizes: tuple[int, ...]) -> torch.Tensor:
    """[B, S, W] rows of the bags side by side (S = Σ bag_sizes) → [B, F, W],
    each field's rows summed."""
    return torch.stack([part.sum(dim=1)
                        for part in rows.split(list(bag_sizes), dim=1)],
                       dim=1)


_grad_rows: dict = {}
_grad_rows_lock = threading.Lock()


def bag_grad_rows(batch: int, bag_sizes: tuple[int, ...],
                  device) -> torch.Tensor:
    """int32 [B·S]: the row of the pooled [B·F, W] gradient that each id of
    the flattened [B, S] bags takes (b·F + its field), made once per shape
    and device (a step's warm-up makes it, never its capture)."""
    key = (batch, tuple(bag_sizes), torch.device(device))
    with _grad_rows_lock:
        rows = _grad_rows.get(key)
        if rows is None:
            field = np.repeat(np.arange(len(bag_sizes)), bag_sizes)
            flat = (np.arange(batch)[:, None] * len(bag_sizes)
                    + field[None, :]).reshape(-1)
            rows = _grad_rows[key] = torch.as_tensor(
                flat.astype(np.int32), device=device)
    return rows


#: the counts of a sparse bag's backward (``counter`` of `bag_sum`): the
#: ids it read and the distinct rows it touched
BAG_COUNTS = ("ids", "unique")


class _SparseBag(torch.autograd.Function):
    """Forward: the row gather of every id and the bags' sums. Backward:
    the touched rows' summed gradients, left in the `SparseTable`."""

    @staticmethod
    def forward(ctx, token, sink, gids, bag_sizes, counter):
        b, s = gids.shape
        flat = gids.reshape(-1)
        rows = row_gather.row_gather(sink.weight, flat)
        ctx.save_for_backward(flat)
        ctx.sink, ctx.bag_sizes, ctx.counter = sink, bag_sizes, counter
        return pool_bags(rows.view(b, s, -1), bag_sizes)

    @staticmethod
    def backward(ctx, d_pooled):
        (flat,) = ctx.saved_tensors
        b, f, w = d_pooled.shape
        sink = ctx.sink
        if sink.grad is not None:
            raise RuntimeError("a sparse table was read by more than one bag "
                               "in a step")
        sink.grad = segment_sum.segment_sum_sparse(
            flat, d_pooled.reshape(b * f, w).contiguous(),
            sink.weight.shape[0], bag_grad_rows(b, ctx.bag_sizes, flat.device))
        if ctx.counter is not None:
            ctx.counter.add(flat, flat.shape[0], sink.grad.count)
        return d_pooled.new_zeros((0,)), None, None, None, None


def bag_sum(table, gids: torch.Tensor, bag_sizes: tuple[int, ...],
            counter: profiling.DeviceCounter | None = None) -> torch.Tensor:
    """Sum-pooled multi-hot bags → [B, F, W]: ``gids`` [B, S] global row
    ids, field f's ``bag_sizes[f]`` ids side by side in field order. On a
    tensor the gather is `table_gather`'s (a dense gradient, where one is
    asked for). On a `SparseTable` (a training step) the backward leaves
    the table's sparse gradient in it, ``counter`` (of `BAG_COUNTS`) adds
    the ids and the touched rows on the device, and the bags are the unit
    ``bags`` of `profiling.UNITS`: ``bags_forward`` before the gather,
    ``bags_forward_end`` after the sums, ``bags_backward`` once their
    gradient has come and ``bags_backward_end`` once the sparse gradient
    has been made."""
    bag_sizes = tuple(int(n) for n in bag_sizes)
    if gids.shape[1] != sum(bag_sizes):
        raise ValueError(f"bag_sum: {gids.shape[1]} ids a row, the bags "
                         f"hold {sum(bag_sizes)}")
    if not isinstance(table, SparseTable):
        return pool_bags(table_gather(table, gids), bag_sizes)
    profiling.mark("bags_forward", gids)
    (token,) = profiling.backward_mark("bags_backward_end", table.token)
    pooled = _SparseBag.apply(token, table, gids, bag_sizes, counter)
    (pooled,) = profiling.backward_mark("bags_backward", pooled)
    profiling.mark("bags_forward_end", pooled)
    return pooled
