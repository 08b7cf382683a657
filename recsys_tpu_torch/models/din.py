"""DIN — Deep Interest Network with target attention (counterpart of
``recsys_tpu/models/din.py``; the reference's din/din.py:83-180).

Batch layout (from `recsys_tpu_torch.data.amazon`):
    {'i_id': int64 [B], 'i_cate': int64 [B],
     'hist_iid': int64 [B, P], 'hist_cate': int64 [B, P]}
with P the padded history length (a bucket of the loader) and id 0 the
padding, masked in the attention.

- item bias table [item_vocab], zero at init, added to the logits;
- item and category tables glorot_normal. Every table is read through
  `table.table_gather` (five reads per batch: the target's and the
  history's item and category, and the target's bias from the ``[V, 1]``
  view of the bias vector). On the card their forward is the row-gather
  kernel and their backward the segment-sum kernel;
- per-position attention MLP (80, 40 → 1) over [hist, query, hist⊙query,
  hist−query] with dropout, masked weighted-sum pooling;
- top MLP (100, 50, 20) over concat(item_emb, item_att, cate_att), no batch
  norm, then a dense layer to one logit.

In train mode the two attention units are bounded by the marks of
``profiling.UNITS['attention']``: ``attention_forward`` before the first
unit's input, ``attention_forward_end`` after the second unit's output, and
in the backward ``attention_backward`` once the units' output gradients have
come, ``attention_backward_end`` once their input gradients have; a captured
step launches them, an eager one none. ``meta['attention_counter']`` (a
`profiling.DeviceCounter` of `interactions.ATTENTION_COUNTS`) sums both
units' rows and real history positions on the device;
``meta['backward_tiles']`` (of `interactions.BACKWARD_TILE_COUNTS`) the
history tiles of the units' fused backward on the card, in all and
computed.

The parameter tree is the JAX model's, so a converted JAX tree drops in.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import ModelConfig
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.models.api import Model, register
from recsys_tpu_torch.ops import interactions, nn
from recsys_tpu_torch.utils import profiling

ITEM_VOCAB = 63002   # din/din.py:88-89
CATE_VOCAB = 802     # din/din.py:90


@register("din")
def make_din(item_vocab: int = ITEM_VOCAB, cate_vocab: int = CATE_VOCAB,
             cfg: ModelConfig = ModelConfig(name="din", embedding_dim=32,
                                            use_bn=False)) -> Model:
    d = cfg.embedding_dim
    counter = profiling.DeviceCounter(interactions.ATTENTION_COUNTS)
    tiles = profiling.DeviceCounter(interactions.BACKWARD_TILE_COUNTS)

    def init(gen: torch.Generator, device):
        params = {
            "item_bias": torch.zeros((item_vocab,), dtype=torch.float32,
                                     device=device),
            "item_emb": nn.glorot_normal(gen, (item_vocab, d), device),
            "cate_emb": nn.glorot_normal(gen, (cate_vocab, d), device),
            "att_item": interactions.din_attention_init(
                gen, d, cfg.attention_layers, device),
            "att_cate": interactions.din_attention_init(
                gen, d, cfg.attention_layers, device),
        }
        mlp_p, mlp_s = nn.mlp_init(gen, 3 * d, cfg.mlp_layers, use_bn=False,
                                   device=device)
        params["mlp"] = mlp_p
        params["final"] = nn.dense_init(gen, cfg.mlp_layers[-1], 1, device)
        return params, {"mlp": mlp_s}

    def apply(params, state, batch, *, train=False, gen=None, emb_ops=None):
        del emb_ops        # DIN's tables are small: always whole, as in JAX
        item_emb = emb_table.table_gather(params["item_emb"], batch["i_id"])
        cate_emb = emb_table.table_gather(params["cate_emb"], batch["i_cate"])
        hist_item = emb_table.table_gather(params["item_emb"],
                                           batch["hist_iid"])
        hist_cate = emb_table.table_gather(params["cate_emb"],
                                           batch["hist_cate"])
        units_in = (hist_item, item_emb, hist_cate, cate_emb)
        if train:
            profiling.mark("attention_forward", hist_item)
            units_in = profiling.backward_mark("attention_backward_end",
                                               *units_in)
        att_item = interactions.din_attention(
            params["att_item"], units_in[0], batch["hist_iid"], units_in[1],
            train=train, dropout_rate=cfg.dropout, gen=gen, counter=counter,
            tile_counter=tiles)
        att_cate = interactions.din_attention(
            params["att_cate"], units_in[2], batch["hist_cate"], units_in[3],
            train=train, dropout_rate=cfg.dropout, gen=gen, counter=counter,
            tile_counter=tiles)
        if train:
            att_item, att_cate = profiling.backward_mark(
                "attention_backward", att_item, att_cate)
            profiling.mark("attention_forward_end", att_cate)

        net = torch.cat([item_emb, att_item, att_cate], dim=1)
        h, mlp_s = nn.mlp_apply(params["mlp"], state["mlp"], net, train=train,
                                dropout_rate=cfg.dropout, gen=gen)
        logits = nn.dense(params["final"], h)[:, 0]
        # the [V] bias is read as a [V, 1] table, like the wide weights
        # (`table.linear_sum`): the row gather forward, the segment sum
        # backward, so its gradient is bitwise repeatable on the card
        logits = logits + emb_table.table_gather(
            params["item_bias"].view(-1, 1), batch["i_id"])[:, 0]
        return logits, {"mlp": mlp_s}

    def sample_features(n: int, hist_len: int = 32) -> dict:
        """Synthetic serving and warm-up features, the JAX model's for the
        same ``n`` (the padded history length is a loader bucket)."""
        rng = np.random.default_rng(0)
        return {
            "i_id": rng.integers(1, item_vocab, n).astype(np.int32),
            "i_cate": rng.integers(1, cate_vocab, n).astype(np.int32),
            "hist_iid": rng.integers(0, item_vocab, (n, hist_len)).astype(
                np.int32),
            "hist_cate": rng.integers(0, cate_vocab, (n, hist_len)).astype(
                np.int32),
        }

    return Model("din", init, apply, meta={"sample_features": sample_features,
                                           "attention_counter": counter,
                                           "backward_tiles": tiles})
