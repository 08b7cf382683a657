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

``V_pad`` stays a multiple of 1024, as in the JAX package, so a converted
JAX table and a port table have the same shape. The JAX package stores its
big table transposed (``[D+1, V_pad]``) for the TPU's lane tiling; the port
keeps rows contiguous, which is what a GPU gather wants, and ``convert.py``
transposes between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import EmbeddingConfig
from recsys_tpu_torch.ops import nn, row_gather, segment_sum

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
