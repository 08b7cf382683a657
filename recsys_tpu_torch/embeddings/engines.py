"""Embedding engine: how a [B, F] id batch becomes the model's embedding
parts (counterpart of ``recsys_tpu/embeddings/engines.py``).

Only ``SplitEngine``'s inference lookup is ported. Fields are partitioned
by vocab size: *small* fields (vocab ≤ ``threshold``) share one packed
table, *big* fields (the hash-capped vocabs) another. Both are row-major
``[V_pad, D+1]`` and both are read with a plain row gather.

The JAX engine's training path turns the small-field lookup into a one-hot
matmul and stores the big table transposed; both exist for the TPU's
per-row gather cost and lane tiling and are not carried over. What is kept
is the ENGINE field order — small fields first, then big — because the
first dense layer's rows and the CIN filters of a converted JAX model are
indexed in that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from recsys_tpu_torch.core.config import EmbeddingConfig
from recsys_tpu_torch.embeddings import table as emb_table

#: Fields with vocab ≤ this live in the small table.
SPLIT_THRESHOLD = 2048


class EmbParts(NamedTuple):
    """Lookup output, in ENGINE field order (small fields, then big).

    - ``emb_2d`` [B, F·D]: field-major flat embeddings.
    - ``wide`` [B, F]: per-field wide weights.
    - ``emb_sum`` / ``emb_sq_sum`` [B, D]: Σ_f e_f and Σ_f e_f², all the
      FM pairwise term needs (`interactions.fm_pairwise_from_sums`).
    - ``field_order`` [F] numpy: engine position → original field index.
    - ``emb_parts``: the (small, big) [B, F_part·D] pieces of ``emb_2d``,
      for ``ops.nn.dense``'s list form.
    """

    emb_2d: torch.Tensor
    wide: torch.Tensor
    emb_sum: torch.Tensor
    emb_sq_sum: torch.Tensor
    field_order: np.ndarray
    emb_parts: tuple | None = None

    def emb_3d(self, num_fields: int, dim: int) -> torch.Tensor:
        """[B, F, D] in engine order (xDeepFM's CIN input)."""
        return self.emb_2d.reshape(self.emb_2d.shape[0], num_fields, dim)


@dataclass(frozen=True)
class SplitEngine:
    cfg: EmbeddingConfig
    threshold: int = SPLIT_THRESHOLD

    def _partition(self) -> tuple[list[int], list[int]]:
        sizes = self.cfg.field_vocab_sizes
        small = [f for f, v in enumerate(sizes) if v <= self.threshold]
        big = [f for f, v in enumerate(sizes) if v > self.threshold]
        return small, big

    def _sizes(self, fields) -> tuple[int, ...]:
        return tuple(self.cfg.field_vocab_sizes[f] for f in fields)

    @property
    def width(self) -> int:
        return self.cfg.embedding_dim + 1

    @property
    def field_order(self) -> np.ndarray:
        small, big = self._partition()
        return np.asarray(small + big, np.int32)

    def init(self, gen: torch.Generator, device) -> dict:
        """{'small': [Vs_pad, D+1], 'big': [Vb_pad, D+1], 'b': scalar}."""
        small, big = self._partition()
        params: dict = {}
        for name, fields in (("small", small), ("big", big)):
            if fields:
                part = EmbeddingConfig(field_vocab_sizes=self._sizes(fields),
                                       embedding_dim=self.cfg.embedding_dim)
                params[name] = emb_table.fused_init(gen, part, device)
        params["b"] = torch.zeros((), dtype=torch.float32, device=device)
        return params

    def _rows(self, table: torch.Tensor, ids: torch.Tensor,
              fields: list[int]) -> torch.Tensor:
        """[B, F_part, D+1] rows of ``fields`` from their packed table."""
        offsets = emb_table.field_offsets(self._sizes(fields))
        sub = ids[:, torch.as_tensor(fields, device=ids.device)]
        gids = sub + torch.as_tensor(offsets, dtype=sub.dtype,
                                     device=ids.device)
        return emb_table.table_gather(table, gids)

    def lookup_parts(self, params, ids: torch.Tensor,
                     train: bool = False) -> EmbParts:
        """Inference lookup; ``ids`` are [B, F] int64 field-local ids."""
        if train:
            raise NotImplementedError(
                "the training lookup (and its backward) is not ported yet")
        small, big = self._partition()
        d = self.cfg.embedding_dim
        b = ids.shape[0]
        emb_parts, wide_parts = [], []
        for name, fields in (("small", small), ("big", big)):
            if fields:
                rows = self._rows(params[name], ids, fields)
                emb_parts.append(rows[:, :, :d].reshape(b, len(fields) * d))
                wide_parts.append(rows[:, :, d])
        emb_2d = torch.cat(emb_parts, dim=1)
        emb_3d = emb_2d.reshape(b, len(small) + len(big), d)
        return EmbParts(
            emb_2d=emb_2d,
            wide=torch.cat(wide_parts, dim=1),
            emb_sum=emb_3d.sum(dim=1),
            emb_sq_sum=emb_3d.square().sum(dim=1),
            field_order=self.field_order,
            emb_parts=tuple(emb_parts),
        )


def make_engine(cfg: EmbeddingConfig, name: str = "split",
                threshold: int = SPLIT_THRESHOLD) -> SplitEngine:
    if name == "split":
        return SplitEngine(cfg, threshold)
    raise ValueError(f"embedding engine {name!r} is not ported yet")
