"""Offset-packed embedding tables (counterpart of
``recsys_tpu/embeddings/table.py``).

All fields of a table live in ONE row-major ``[V_pad, D+1]`` matrix: columns
``0..D-1`` are the embedding, column ``D`` the wide/linear weight, and a
batch of field-local ids is shifted by static per-field offsets into global
row ids and fetched with one gather.

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
from recsys_tpu_torch.ops import nn

#: Row-count multiple of every packed table (the JAX package's TILE_V).
ROW_MULTIPLE = 1024


def field_offsets(field_vocab_sizes: tuple[int, ...]) -> np.ndarray:
    """Static cumulative offsets turning field-local ids into packed rows."""
    return np.concatenate([[0], np.cumsum(field_vocab_sizes[:-1])]).astype(
        np.int32
    )


def pad_rows(total: int, multiple: int = ROW_MULTIPLE) -> int:
    return (total + multiple - 1) // multiple * multiple


def fused_init(gen: torch.Generator, cfg: EmbeddingConfig,
               device) -> torch.Tensor:
    """[V_pad, D+1] packed table: cols 0..D-1 embedding (truncated-normal
    1/sqrt(D)), col D wide weight (glorot over the virtual [V, 1] kernel)."""
    v = pad_rows(cfg.total_vocab)
    dtype = getattr(torch, cfg.dtype)
    emb = nn.embedding_init(gen, (v, cfg.embedding_dim), device, dtype)
    wide = nn.glorot_uniform(gen, (v, 1), device, dtype)
    return torch.cat([emb, wide], dim=1)


def table_gather(table: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """Row-major gather: ``[V, W]`` table + global ids of any shape →
    rows ``[*gids.shape, W]``."""
    rows = torch.index_select(table, 0, gids.reshape(-1))
    return rows.reshape(*gids.shape, table.shape[1])
