"""DLRM with a DCN-v2 interaction (the model of MLPerf Training's
recommendation benchmark: mlcommons/training ``recommendation_v2/
torchrec_dlrm``; DLRM, arXiv:1906.00091; DCN-V2, arXiv:2008.13535), which
the JAX package has not.

Batch layout:
    {'ids': int64 [B, S] field-local ids, field f's ``bag_sizes[f]`` ids
            side by side in field order (S = Σ bag_sizes),
     'dense': float32 [B, num_dense] (log-scaled counts),
     'label': float32 [B]}

- One packed row-major table [Σ vocabs, D] holds every field's rows, each
  field from its offset; a field's bag is the sum of its rows
  (`table.bag_sum`: one row gather, then the sum over each field's span).
- Bottom MLP over the dense features (512-256-128, ReLU after every layer).
- x0 = concat(bottom output, the F pooled rows): (F + 1)·D wide. Then the
  low-rank cross layers x_{l+1} = x0 ⊙ (W_l (V_l x_l) + b_l) + x_l
  (`interactions.lowrank_cross_apply`).
- Top MLP (1024-1024-512-256, ReLU), then a dense layer to one logit.
- Tables U(±√(1/n)) with n the field's published row count (``init_rows``,
  by default its vocabulary), linear layers ``torch.nn.Linear``'s default.

In training the table is read as a `table.SparseTable`
(``meta['sparse_tables']``): the bags' backward gives the touched rows'
summed gradients and nothing of the table's size, and
``meta['optimizer']`` asks for row-wise Adagrad (`optim.rowwise_adagrad`).
The bags and the cross stack are bounded by unit marks
(``profiling.UNITS['bags']`` and ``['cross']``, forward and backward), which
a captured step launches and an eager one does not;
``meta['bag_counter']`` (a `profiling.DeviceCounter` of
`table.BAG_COUNTS`) sums the ids read and the rows touched on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.models.api import Model, register
from recsys_tpu_torch.ops import interactions, nn
from recsys_tpu_torch.utils import profiling


@register("dlrm_dcnv2")
def make_dlrm(vocabs: tuple[int, ...], bag_sizes: tuple[int, ...], *,
              embedding_dim: int = 128, num_dense: int = 13,
              bottom_layers: tuple[int, ...] = (512, 256, 128),
              top_layers: tuple[int, ...] = (1024, 1024, 512, 256),
              cross_layers: int = 3, cross_rank: int = 512,
              init_rows: tuple[int, ...] | None = None) -> Model:
    vocabs, bag_sizes = tuple(vocabs), tuple(bag_sizes)
    if len(vocabs) != len(bag_sizes):
        raise ValueError(f"dlrm: {len(vocabs)} tables, {len(bag_sizes)} "
                         "bag sizes")
    if bottom_layers[-1] != embedding_dim:
        raise ValueError(f"dlrm: the bottom MLP ends at {bottom_layers[-1]}, "
                         f"the rows are {embedding_dim} wide")
    d, f = embedding_dim, len(vocabs)
    init_rows = tuple(init_rows or vocabs)
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    slot_offsets = np.repeat(offsets, bag_sizes).astype(np.int64)
    on_device: dict = {}
    counter = profiling.DeviceCounter(emb_table.BAG_COUNTS)

    def init(gen: torch.Generator, device):
        table = nn._host_empty((sum(vocabs), d), device, torch.float32)
        for lo, v, n in zip(offsets, vocabs, init_rows):
            limit = n ** -0.5
            table[lo:lo + v].uniform_(-limit, limit, generator=gen)
        params = {
            "table": table.to(device),
            "bottom": nn.linear_mlp_init(gen, num_dense, bottom_layers,
                                         device),
            "cross": interactions.lowrank_cross_init(
                gen, (f + 1) * d, cross_rank, cross_layers, device),
            "top": nn.linear_mlp_init(gen, (f + 1) * d, top_layers, device),
            "final": nn.linear_init(gen, top_layers[-1], 1, device),
        }
        return params, {}

    def global_ids(ids: torch.Tensor) -> torch.Tensor:
        off = on_device.get(ids.device)
        if off is None:    # a step's warm-up, never its capture
            off = on_device[ids.device] = torch.as_tensor(slot_offsets,
                                                          device=ids.device)
        return ids + off

    def apply(params, state, batch, *, train=False, gen=None, emb_ops=None):
        del state, gen, emb_ops   # no batch norm, no dropout, whole tables
        b = batch["ids"].shape[0]
        none = {"layers": []}
        h, _ = nn.mlp_apply(params["bottom"], none, batch["dense"],
                            train=train)
        pooled = emb_table.bag_sum(params["table"], global_ids(batch["ids"]),
                                   bag_sizes, counter=counter)
        x0 = torch.cat([h[:, None, :], pooled], dim=1).reshape(b, (f + 1) * d)
        if train:
            (x0,) = profiling.backward_mark("cross_backward_end", x0)
            profiling.mark("cross_forward", x0)
        x = interactions.lowrank_cross_apply(params["cross"], x0)
        if train:
            (x,) = profiling.backward_mark("cross_backward", x)
            profiling.mark("cross_forward_end", x)
        top, _ = nn.mlp_apply(params["top"], none, x, train=train)
        return nn.dense(params["final"], top)[:, 0], {}

    return Model("dlrm_dcnv2", init, apply,
                 meta={"sparse_tables": ("table",),
                       "optimizer": "rowwise_adagrad",
                       "bag_counter": counter})
