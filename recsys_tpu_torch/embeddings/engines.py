"""Embedding engine: how a [B, F] id batch becomes the model's embedding
parts (counterpart of ``recsys_tpu/embeddings/engines.py``).

Only ``SplitEngine`` is ported. Fields are partitioned by vocab size:
*small* fields (vocab ≤ ``threshold``) share one packed table, *big* fields
(the hash-capped vocabs) another. Both are row-major ``[V_pad, D+1]`` and
both are read with `table.table_gather`, in training as in inference: two
gathers per step, whose backward is two segment sums.

The JAX engine's training path turns the small-field lookup into a one-hot
matmul and stores the big table transposed; both exist for the TPU's
per-row gather cost and lane tiling and are not carried over. What is kept
is the ENGINE field order — small fields first, then big — because the
first dense layer's rows and the CIN filters of a converted JAX model are
indexed in that order.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
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
    #: per device: the (fields, offsets) index tensors of each part, built
    #: once so that a lookup sends nothing from the host
    _consts: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)
    _consts_lock: threading.Lock = field(default_factory=threading.Lock,
                                         init=False, repr=False,
                                         compare=False)

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

    def _index_tensors(self, device) -> list[tuple[str, int, torch.Tensor,
                                                   torch.Tensor]]:
        """[(part name, field count, fields [F_part], offsets [F_part])] on
        ``device``, for the parts that have fields."""
        device = torch.device(device)
        with self._consts_lock:
            consts = self._consts.get(device)
            if consts is None:
                consts = []
                for name, fields in zip(("small", "big"), self._partition()):
                    if fields:
                        offsets = emb_table.field_offsets(self._sizes(fields))
                        consts.append((
                            name, len(fields),
                            torch.as_tensor(fields, dtype=torch.int64,
                                            device=device),
                            torch.as_tensor(offsets, dtype=torch.int64,
                                            device=device)))
                self._consts[device] = consts
            return consts

    def lookup_parts(self, params, ids: torch.Tensor,
                     train: bool = False) -> EmbParts:
        """Lookup of [B, F] int64 field-local ids. Training and inference
        take the same path (``train`` is accepted for the JAX signature):
        the gathers are differentiable in the tables."""
        del train
        d = self.cfg.embedding_dim
        b = ids.shape[0]
        emb_parts, wide_parts = [], []
        for name, nf, fields, offsets in self._index_tensors(ids.device):
            gids = ids.index_select(1, fields) + offsets
            rows = emb_table.table_gather(params[name], gids)
            emb_parts.append(rows[:, :, :d].reshape(b, nf * d))
            wide_parts.append(rows[:, :, d])
        emb_2d = torch.cat(emb_parts, dim=1)
        emb_3d = emb_2d.reshape(b, -1, d)
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
