"""Criteo CTR models (counterpart of ``recsys_tpu/models/ctr.py``): FM,
DeepFM, DCN, xDeepFM, DNN and the wide linear model.

Parameter trees keep the JAX package's structure and ENGINE field order, so
a converted JAX tree gives the same logits and gradients
(tests/test_torch_xdeepfm.py, tests/test_torch_train.py,
tests/test_torch_zoo.py). Every model but ``wide`` reads its embeddings
through the engine of ``cfg.emb_engine`` (``split`` or ``fused``).

Every model takes an ``emb_ops`` (`api.EmbOps`, `api.LOCAL_EMB_OPS` by
default): the SPMD step (``parallel/spmd.py``) passes sharded ops, which
route the engine's lookup through the dedup + all-to-all exchange over the
mesh's model axis and the wide model's weights through the sharded wide
sum.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import (CriteoConfig, EmbeddingConfig,
                                          ModelConfig)
from recsys_tpu_torch.embeddings import engines
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.models.api import (LOCAL_EMB_OPS, EmbOps, Model,
                                          register)
from recsys_tpu_torch.ops import interactions, nn


def _squeeze_logits(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] if x.dim() == 2 else x


class _CriteoBase:
    """Shared wiring: the embedding engine over the Criteo fields."""

    def __init__(self, criteo: CriteoConfig, cfg: ModelConfig):
        emb_cfg = EmbeddingConfig(field_vocab_sizes=criteo.field_vocab_sizes,
                                  embedding_dim=cfg.embedding_dim)
        self.num_fields = len(criteo.field_vocab_sizes)
        self.offsets = emb_table.field_offsets(criteo.field_vocab_sizes)
        self.engine = engines.make_engine(emb_cfg, cfg.emb_engine,
                                          threshold=cfg.split_threshold)
        # 'engine' lets the SPMD drivers run the host-side capacity check
        # (engine.a2a_overflow) before they enter the sharded path
        self.meta = {"emb_width": cfg.embedding_dim + 1,
                     "engine": self.engine}
        self._offsets_on: dict = {}

    def gids(self, batch) -> torch.Tensor:
        """[B, F] packed global row ids of the batch's field-local ids (the
        offsets sent to each device once)."""
        ids = batch["ids"]
        if ids.device not in self._offsets_on:
            self._offsets_on[ids.device] = torch.as_tensor(
                self.offsets, dtype=torch.int64, device=ids.device)
        return emb_table.to_global_ids(ids, self._offsets_on[ids.device])

    def init_fused(self, gen: torch.Generator, device) -> dict:
        """Engine-owned tables (+ shared wide bias)."""
        return {"tables": self.engine.init(gen, device)}

    def lookup_parts(self, params, batch, emb_ops: EmbOps,
                     train: bool = False):
        """The engine's parts; sharded ops take the engine's dedup +
        all-to-all lookup over their model axis."""
        if emb_ops.sharded:
            return self.engine.lookup_parts_sharded(
                params["tables"], batch["ids"], emb_ops.axis,
                exact=emb_ops.a2a_exact, cap_factor=emb_ops.a2a_cap_factor)
        return self.engine.lookup_parts(params["tables"], batch["ids"],
                                        train=train)


def _mlp_input(parts: engines.EmbParts):
    """The split engine's parts feed the first dense layer in list form
    (no concat); the fused engine has none and gives ``emb_2d``."""
    return parts.emb_parts if parts.emb_parts is not None else parts.emb_2d


# ---------------------------------------------------------------------------
# FM — fm/fm.py:115-170
# ---------------------------------------------------------------------------

@register("fm")
def make_fm(criteo: CriteoConfig = CriteoConfig(),
            cfg: ModelConfig = ModelConfig(name="fm")) -> Model:
    """Factorization machine: y_1d = relu(Σ wide weights + the tables'
    shared bias); y_2d = the FM identity over the field sums; logits =
    dense(concat(y_1d, y_2d))."""
    base = _CriteoBase(criteo, cfg)

    def init(gen: torch.Generator, device):
        params = base.init_fused(gen, device)
        params["final"] = nn.dense_init(gen, 2, 1, device)
        return params, {}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        y_1d = torch.relu(parts.wide.sum(dim=1, keepdim=True)
                          + params["tables"]["b"])
        y_2d = interactions.fm_pairwise_from_sums(parts.emb_sum,
                                                  parts.emb_sq_sum)
        logits = nn.dense(params["final"], torch.cat([y_1d, y_2d], dim=-1))
        return _squeeze_logits(logits), state

    return Model("fm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DeepFM — deepfm/deepfm.py:73-150 (README Criteo config: DNN 100,100)
# ---------------------------------------------------------------------------

@register("deepfm")
def make_deepfm(criteo: CriteoConfig = CriteoConfig(),
                cfg: ModelConfig = ModelConfig(name="deepfm")) -> Model:
    """DeepFM: wide + FM second order + DNN over one embedding space.

    y_1d = relu(Σ wide weights + the tables' shared bias); y_2d = the FM
    identity over the field sums; y_dnn = relu(dense(MLP tower over the flat
    embeddings)), the first dense layer taking the engine's parts (list
    form); logits = dense(concat(y_1d, y_2d, y_dnn)).
    """
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(gen: torch.Generator, device):
        params = base.init_fused(gen, device)
        mlp_p, mlp_s = nn.mlp_init(gen, flat_dim, cfg.deep_layers, cfg.use_bn,
                                   device)
        params["dnn"] = mlp_p
        params["dnn_out"] = nn.dense_init(gen, cfg.deep_layers[-1], 1, device)
        params["final"] = nn.dense_init(gen, 3, 1, device)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        y_1d = torch.relu(parts.wide.sum(dim=1, keepdim=True)
                          + params["tables"]["b"])
        y_2d = interactions.fm_pairwise_from_sums(parts.emb_sum,
                                                  parts.emb_sq_sum)
        h, dnn_s = nn.mlp_apply(params["dnn"], state["dnn"],
                                _mlp_input(parts), train=train,
                                dropout_rate=cfg.dropout, gen=gen)
        y_dnn = nn.dense(params["dnn_out"], h, activation=torch.relu)
        logits = nn.dense(params["final"],
                          torch.cat([y_1d, y_2d, y_dnn], dim=-1))
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("deepfm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DCN — dcn/dcn.py:117-190
# ---------------------------------------------------------------------------

@register("dcn")
def make_dcn(criteo: CriteoConfig = CriteoConfig(),
             cfg: ModelConfig = ModelConfig(name="dcn", embedding_dim=16,
                                            cross_layers=4)) -> Model:
    """Deep & Cross: x0 = the flat field embeddings [B, F·D]; the cross
    stack x_{l+1} = x0·(x_l⊤w) + x_l + b; the MLP tower over x0; logits =
    dense(concat(tower, x_L)). The reference's unused linear branch is not
    reproduced, as in the JAX package."""
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(gen: torch.Generator, device):
        params = base.init_fused(gen, device)
        params["cross"] = interactions.cross_init(gen, flat_dim,
                                                  cfg.cross_layers, device)
        mlp_p, mlp_s = nn.mlp_init(gen, flat_dim, cfg.deep_layers, cfg.use_bn,
                                   device)
        params["dnn"] = mlp_p
        params["final"] = nn.dense_init(gen, cfg.deep_layers[-1] + flat_dim,
                                        1, device)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        x0 = parts.emb_2d
        xl = interactions.cross_apply(params["cross"], x0)
        h, dnn_s = nn.mlp_apply(params["dnn"], state["dnn"], x0, train=train,
                                dropout_rate=cfg.dropout, gen=gen)
        logits = nn.dense(params["final"], torch.cat([h, xl], dim=-1))
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("dcn", init, apply, meta=base.meta)


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
    # ≥ n_cont) — static subset of parts.wide, one copy per device
    cat_pos = np.where(base.engine.field_order >= n_cont)[0]
    cat_pos_on: dict = {}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        dev = parts.wide.device
        if dev not in cat_pos_on:
            cat_pos_on[dev] = torch.as_tensor(cat_pos, device=dev)
        wide_cat = parts.wide.index_select(1, cat_pos_on[dev])
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

    return Model("xdeepfm", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# DNN baseline (README.md:68-78: raw embeddings + a 100-100 tower)
# ---------------------------------------------------------------------------

@register("dnn")
def make_dnn(criteo: CriteoConfig = CriteoConfig(),
             cfg: ModelConfig = ModelConfig(name="dnn")) -> Model:
    """logits = dense(MLP tower over the flat embeddings)."""
    base = _CriteoBase(criteo, cfg)
    flat_dim = base.num_fields * cfg.embedding_dim

    def init(gen: torch.Generator, device):
        params = base.init_fused(gen, device)
        mlp_p, mlp_s = nn.mlp_init(gen, flat_dim, cfg.deep_layers, cfg.use_bn,
                                   device)
        params["dnn"] = mlp_p
        params["final"] = nn.dense_init(gen, cfg.deep_layers[-1], 1, device)
        return params, {"dnn": mlp_s}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        parts = base.lookup_parts(params, batch, emb_ops, train=train)
        h, dnn_s = nn.mlp_apply(params["dnn"], state["dnn"], _mlp_input(parts),
                                train=train, dropout_rate=cfg.dropout,
                                gen=gen)
        logits = nn.dense(params["final"], h)
        return _squeeze_logits(logits), {"dnn": dnn_s}

    return Model("dnn", init, apply, meta=base.meta)


# ---------------------------------------------------------------------------
# WideLinear — deep&wide/deep&wide.py:114-149 (the canned LinearClassifier
# on the linear columns; the reference never builds the deep part)
# ---------------------------------------------------------------------------

@register("wide")
def make_wide(criteo: CriteoConfig = CriteoConfig(),
              cfg: ModelConfig = ModelConfig(name="wide")) -> Model:
    """logits = Σ_f w[gid_f] + b over all fields (``emb_ops.linear``:
    `table.linear_sum`, or the sharded wide sum in the SPMD step).
    ``meta['optimizer'] = 'ftrl'``: the reference's LinearClassifier is
    FTRL-backed, and ``optim.for_model`` honours it."""
    base = _CriteoBase(criteo, cfg)

    def init(gen: torch.Generator, device):
        return {"wide": emb_table.linear_init(gen, criteo.field_vocab_sizes,
                                              device)}, {}

    def apply(params, state, batch, *, train=False, gen=None,
              emb_ops: EmbOps = LOCAL_EMB_OPS):
        logits = emb_ops.linear(params["wide"], base.gids(batch))
        return _squeeze_logits(logits), state

    return Model("wide", init, apply, meta=dict(base.meta, optimizer="ftrl"))
