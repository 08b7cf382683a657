"""Embedding engines: how a [B, F] id batch becomes the model's embedding
parts (counterpart of ``recsys_tpu/embeddings/engines.py``).

**SplitEngine** (the default): fields are partitioned by vocab size:
*small* fields (vocab ≤ ``threshold``) share one packed table, *big* fields
(the hash-capped vocabs) another. Both are row-major ``[V_pad, D+1]`` and
both are read with `table.table_gather`, in training as in inference: two
gathers per step, whose backward is two segment sums.

**FusedGatherEngine** (``emb_engine='fused'``): all fields in one packed
table, kept flat as the JAX package keeps it (``table_flat``
``[V_pad·(D+1)]``, so checkpoints and ``convert.py`` need no mapping) and
read through its ``[V_pad, D+1]`` view with one `table.table_gather`: one
row gather and one segment sum per step. The JAX engine's
flat-gradient ``table_gather_flat`` exists for the TPU's tiling: a view is
free here, and the segment sum's ``[V_pad, D+1]`` gradient reaches
``table_flat`` through it.

The JAX engine's training path turns the small-field lookup into a one-hot
matmul and stores the big table transposed; both exist for the TPU's
per-row gather cost and lane tiling and are not carried over. What is kept
is the ENGINE field order — small fields first, then big — because the
first dense layer's rows and the CIN filters of a converted JAX model are
indexed in that order.

Inside the SPMD step (``parallel/spmd.py``) each engine's
``lookup_parts_sharded`` reads a table split by rows over the mesh's model
axis through the dedup + all-to-all exchange
(``parallel/sharded_embedding.py``): the fused engine its one table, the
split engine its big table only (the small one stays whole on every
member). ``a2a_overflow`` is the host-side check of a batch against the
exchange's capacity.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from recsys_tpu_torch.core.config import EmbeddingConfig
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.parallel import sharded_embedding as SE
from recsys_tpu_torch.parallel.collectives import Axis

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


def _parts_from_rows(emb: torch.Tensor, wide: torch.Tensor,
                     field_order: np.ndarray) -> EmbParts:
    """EmbParts from a [B, F, D] + [B, F] lookup (the row-tensor engines);
    ``emb_parts`` stays None, so models feed ``emb_2d`` to their MLP."""
    b, f, d = emb.shape
    return EmbParts(
        emb_2d=emb.reshape(b, f * d),
        wide=wide,
        emb_sum=emb.sum(dim=1),
        emb_sq_sum=emb.square().sum(dim=1),
        field_order=field_order,
    )


def _on_device(cache: dict, lock: threading.Lock, device, make):
    """``cache[device]``, made once by ``make(device)`` under ``lock``."""
    device = torch.device(device)
    with lock:
        value = cache.get(device)
        if value is None:
            value = cache[device] = make(device)
        return value


@dataclass(frozen=True)
class FusedGatherEngine:
    """All fields through one packed flat ``[V_pad·(D+1)]`` table and a
    single gather."""

    cfg: EmbeddingConfig
    #: per device: the field offsets as a tensor, built once
    _consts: dict = field(default_factory=dict, init=False, repr=False,
                          compare=False)
    _consts_lock: threading.Lock = field(default_factory=threading.Lock,
                                         init=False, repr=False,
                                         compare=False)

    @property
    def offsets(self) -> np.ndarray:
        return emb_table.field_offsets(self.cfg.field_vocab_sizes)

    @property
    def width(self) -> int:
        return self.cfg.embedding_dim + 1

    @property
    def v_pad(self) -> int:
        return emb_table.pad_rows(self.cfg.total_vocab)

    @property
    def field_order(self) -> np.ndarray:
        return np.arange(len(self.cfg.field_vocab_sizes), dtype=np.int32)

    def init(self, gen: torch.Generator, device) -> dict:
        """{'table_flat': [V_pad·(D+1)], 'b': scalar}."""
        table = emb_table.fused_init(gen, self.cfg, device)
        return {"table_flat": table.reshape(-1),
                "b": torch.zeros((), dtype=torch.float32, device=device)}

    def lookup(self, params, ids: torch.Tensor, train: bool = False):
        """(emb [B, F, D], wide [B, F]) of [B, F] int64 field-local ids,
        differentiable in ``table_flat``."""
        del train          # the gather is the path of both
        table = params["table_flat"].view(self.v_pad, self.width)
        rows = emb_table.table_gather(table, self._gids(ids))
        return rows[:, :, :-1], rows[:, :, -1]

    def lookup_parts(self, params, ids: torch.Tensor,
                     train: bool = False) -> EmbParts:
        emb, wide = self.lookup(params, ids, train=train)
        return _parts_from_rows(emb, wide, self.field_order)

    def _gids(self, ids: torch.Tensor) -> torch.Tensor:
        offsets = _on_device(
            self._consts, self._consts_lock, ids.device,
            lambda d: torch.as_tensor(self.offsets, dtype=torch.int64,
                                      device=d))
        return emb_table.to_global_ids(ids, offsets)

    def lookup_parts_sharded(self, params, ids: torch.Tensor, axis: Axis,
                             exact: bool = False,
                             cap_factor: float = 2.0) -> EmbParts:
        """`lookup_parts` with ``params['table_flat']`` this member's row
        shard, read through the dedup + all-to-all exchange over
        ``axis``."""
        local = params["table_flat"].view(-1, self.width)
        rows = SE.a2a_embedding_lookup(local, self._gids(ids), axis,
                                       exact=exact, cap_factor=cap_factor)
        return _parts_from_rows(rows[:, :, :-1], rows[:, :, -1],
                                self.field_order)

    def a2a_overflow(self, ids, num_data: int, num_model: int,
                     cap_factor: float = 2.0) -> int:
        """Unique ids of a host batch ``ids`` [B, F] that would exceed the
        exchange's per-owner capacity at ``cap_factor`` (0 == lossless),
        worst over the batch's ``num_data`` row shards."""
        gids = np.asarray(ids) + self.offsets[None, :]
        shard_rows = self.v_pad // num_model
        return max(SE.a2a_overflow(s, num_model, shard_rows, cap_factor)
                   for s in np.array_split(gids, num_data, axis=0))


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
        def make(device):
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
            return consts

        return _on_device(self._consts, self._consts_lock, device, make)

    def lookup_parts(self, params, ids: torch.Tensor,
                     train: bool = False) -> EmbParts:
        """Lookup of [B, F] int64 field-local ids. Training and inference
        take the same path (``train`` is accepted for the JAX signature):
        the gathers are differentiable in the tables."""
        del train
        return self._parts(params, ids,
                           lambda name, table, gids:
                           emb_table.table_gather(table, gids))

    def lookup_parts_sharded(self, params, ids: torch.Tensor, axis: Axis,
                             exact: bool = False,
                             cap_factor: float = 2.0) -> EmbParts:
        """`lookup_parts` with ``params['big']`` this member's row shard,
        read through the dedup + all-to-all exchange over ``axis``; the
        small table is whole on every member and read locally. Same math
        and order as `lookup_parts`, so local and sharded outputs agree."""
        return self._parts(params, ids, self._sharded_read(axis, exact,
                                                           cap_factor))

    def _sharded_read(self, axis: Axis, exact: bool, cap_factor: float):
        def read(name, table, gids):
            if name == "big":
                return SE.a2a_embedding_lookup(table, gids, axis,
                                               exact=exact,
                                               cap_factor=cap_factor)
            return emb_table.table_gather(table, gids)
        return read

    def a2a_overflow(self, ids, num_data: int, num_model: int,
                     cap_factor: float = 2.0) -> int:
        """As `FusedGatherEngine.a2a_overflow`; only the big fields travel
        over the exchange in this engine."""
        big = self._partition()[1]
        if not big:
            return 0
        offsets = emb_table.field_offsets(self._sizes(big))
        gids = np.asarray(ids)[:, big] + offsets[None, :]
        shard_rows = emb_table.pad_rows(sum(self._sizes(big))) // num_model
        return max(SE.a2a_overflow(s, num_model, shard_rows, cap_factor)
                   for s in np.array_split(gids, num_data, axis=0))

    def _parts(self, params, ids: torch.Tensor, read) -> EmbParts:
        """EmbParts with each part's rows from ``read(part name, table,
        gids)``."""
        d = self.cfg.embedding_dim
        b = ids.shape[0]
        emb_parts, wide_parts = [], []
        for name, nf, fields, offsets in self._index_tensors(ids.device):
            gids = ids.index_select(1, fields) + offsets
            rows = read(name, params[name], gids)
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
                threshold: int = SPLIT_THRESHOLD):
    if name == "split":
        return SplitEngine(cfg, threshold)
    if name == "fused":
        return FusedGatherEngine(cfg)
    raise ValueError(f"unknown embedding engine {name!r}")
