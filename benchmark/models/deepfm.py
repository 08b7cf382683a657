"""DeepFM's plain reference (wangruichens/recsys ``deepfm/deepfm.py``):

    y_1d  = relu(Σ_f wide[id_f] + b)
    y_2d  = Σ_{f<g} <e_f, e_g>
    y_dnn = relu(dense(MLP(concat_f e_f)))
    logit = dense([y_1d, y_2d, y_dnn])

in the configuration's field order, every product through ``mm``.
Plain PyTorch: imports nothing of the port.
"""

from __future__ import annotations

import torch

from benchmark.models import criteo


def spec(config: dict) -> list:
    """(path, shape, init) of every weight."""
    n_in = len(criteo.field_vocabs(config)) * config["embedding_dim"]
    return (criteo.table_spec(config) + criteo.mlp_spec(config, n_in)
            + criteo.dense_spec(("dnn_out",), config["deep_layers"][-1], 1)
            + criteo.dense_spec(("final",), 3, 1))


def forward(config: dict, params: dict, ids, dense_vals, masks,
            mm) -> torch.Tensor:
    """Train-mode logits [B] with the dropout masks given."""
    del dense_vals       # DeepFM reads the continuous fields as buckets only
    emb, wide = criteo.lookup(config, params, ids)
    y_1d = torch.relu(wide.sum(dim=1, keepdim=True) + params["b"])
    y_2d = criteo.fm_pairwise(emb)
    h = criteo.mlp(config, params["dnn"]["layers"],
                   emb.reshape(emb.shape[0], -1), masks, mm)
    y_dnn = torch.relu(criteo.dense(params["dnn_out"], h, mm))
    return criteo.dense(params["final"],
                        torch.cat([y_1d, y_2d, y_dnn], dim=1), mm)[:, 0]


def forward_flops(config: dict) -> float:
    """Model flops of one example's forward pass: 2 per multiply-add of the
    dense layers (the tower, its output, the final layer) and of the FM
    term (Σ_f e_f and Σ_f e_f² over F·D values, their difference over D).
    Lookups count none."""
    f, d = len(criteo.field_vocabs(config)), config["embedding_dim"]
    return criteo.dnn_flops(config, f * d) + 2.0 * (3 + 2 * f * d + d)


def kernel_work(config: dict, traffic: dict) -> dict:
    """(bytes, flops) of each launch of the port's kernels in one step, by
    family."""
    return {"embedding": criteo.embedding_work(config, traffic)}
