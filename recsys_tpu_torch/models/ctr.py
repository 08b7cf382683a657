"""Criteo CTR models (counterpart of ``recsys_tpu/models/ctr.py``).

Only xDeepFM is ported; the rest of the zoo follows. Parameter trees keep
the JAX package's structure and ENGINE field order, so a converted JAX tree
gives the same logits (tests/test_torch_xdeepfm.py).
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import (CriteoConfig, EmbeddingConfig,
                                          ModelConfig)
from recsys_tpu_torch.embeddings import engines
from recsys_tpu_torch.models.api import Model, register
from recsys_tpu_torch.ops import interactions, nn


def _squeeze_logits(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] if x.dim() == 2 else x


class _CriteoBase:
    """Shared wiring: the embedding engine over the Criteo fields."""

    def __init__(self, criteo: CriteoConfig, cfg: ModelConfig):
        emb_cfg = EmbeddingConfig(field_vocab_sizes=criteo.field_vocab_sizes,
                                  embedding_dim=cfg.embedding_dim)
        self.num_fields = len(criteo.field_vocab_sizes)
        self.engine = engines.make_engine(emb_cfg, cfg.emb_engine,
                                          threshold=cfg.split_threshold)

    def init_fused(self, gen: torch.Generator, device) -> dict:
        """Engine-owned tables (+ shared wide bias)."""
        return {"tables": self.engine.init(gen, device)}

    def lookup_parts(self, params, batch, train: bool = False):
        return self.engine.lookup_parts(params["tables"], batch["ids"],
                                        train=train)


# ---------------------------------------------------------------------------
# xDeepFM — xdeepfm/xdeepfm.py:123-233
# ---------------------------------------------------------------------------

@register("xdeepfm")
def make_xdeepfm(criteo: CriteoConfig = CriteoConfig(),
                 cfg: ModelConfig = ModelConfig(name="xdeepfm")) -> Model:
    """xDeepFM: linear + CIN + DNN.

    linear_y = relu(dense(dense_vals) + Σ wide weights of the categorical
    fields); cin_y = relu(dense(CIN pools)); dnn_y = relu(dense(MLP tower
    over the flat embeddings)); logits = dense(concat(linear_y, cin_y,
    dnn_y)). Embeddings and wide weights arrive in engine field order.
    """
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim
    n_cont = len(criteo.cont_boundaries)

    def init(gen: torch.Generator, device):
        params = base.init_fused(gen, device)
        params["lin_dense"] = nn.dense_init(gen, n_cont, 1, device)
        params["cin"] = interactions.cin_init(gen, base.num_fields,
                                              cfg.cin_layers, device)
        params["cin_out"] = nn.dense_init(gen, sum(cfg.cin_layers), 1, device)
        mlp_p, mlp_s = nn.mlp_init(gen, flat_dim, cfg.deep_layers, cfg.use_bn,
                                   device)
        params["dnn"] = mlp_p
        params["dnn_out"] = nn.dense_init(gen, cfg.deep_layers[-1], 1, device)
        params["final"] = nn.dense_init(gen, 3, 1, device)
        return params, {"dnn": mlp_s}

    # engine-order positions of the categorical fields (original index
    # ≥ n_cont) — static subset of parts.wide
    cat_pos = np.where(base.engine.field_order >= n_cont)[0]

    def apply(params, state, batch, *, train=False, gen=None):
        parts = base.lookup_parts(params, batch, train=train)
        wide_cat = parts.wide[:, torch.as_tensor(cat_pos,
                                                 device=parts.wide.device)]
        lin = (nn.dense(params["lin_dense"], batch["dense"])
               + wide_cat.sum(dim=1, keepdim=True))
        linear_y = torch.relu(lin)
        emb = parts.emb_3d(base.num_fields, cfg.embedding_dim)
        cin_pool = interactions.cin_apply(params["cin"], emb)
        cin_y = nn.dense(params["cin_out"], cin_pool, activation=torch.relu)

        h, dnn_s = nn.mlp_apply(params["dnn"], state["dnn"], parts.emb_2d,
                                train=train, dropout_rate=cfg.dropout, gen=gen)
        dnn_y = nn.dense(params["dnn_out"], h, activation=torch.relu)

        logits = nn.dense(params["final"],
                          torch.cat([linear_y, cin_y, dnn_y], dim=-1))
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("xdeepfm", init, apply)
