"""The JAX package's initial weights of the Criteo zoo for a seed, rebuilt
in numpy (`core.jax_prng`), in the JAX package's layout.

``recsys_tpu/train/train_state.create_train_state(model, seed)`` splits
``key(seed)`` into an init key and a run key and calls ``model.init(init
key)``; each model's ``init`` splits its key in a fixed order among the
embedding engine, its towers and its final layer. `init_params` replays
those splits and draws for ``wide``, ``fm``, ``deepfm``, ``dcn``,
``xdeepfm`` and ``dnn`` on the split engine, so that a port run (through
``convert.convert_params``) starts from the weights a JAX run of the same
seed starts from: equal up to an ulp of the truncated normals' ``erfinv``
(`jax_prng`). ``tools/converge.py`` starts from them: the protocol's FM
result depends on the starting draw.
"""

from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core import jax_prng as R
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.embeddings.table import pad_rows

MODELS = ("wide", "fm", "deepfm", "dcn", "xdeepfm", "dnn")


def _glorot_uniform(k, shape) -> np.ndarray:
    fan_in, fan_out = shape[0], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return R.uniform(k, shape, -limit, limit)


def _glorot_normal_1d(k, dim: int) -> np.ndarray:
    std = (2.0 / (dim + dim)) ** 0.5
    return np.float32(std) * R.normal(k, (dim,))


def _dense(k, in_dim: int, out_dim: int) -> dict:
    kw, _ = R.split(k)
    return {"w": _glorot_uniform(kw, (in_dim, out_dim)),
            "b": np.zeros((out_dim,), np.float32)}


def _fused_table(k, vocabs: tuple[int, ...], dim: int) -> np.ndarray:
    """[V_pad, D+1]: a truncated normal of std 1/√D, then the wide column
    (glorot over the virtual [V_pad, 1] kernel)."""
    v = pad_rows(sum(vocabs))
    k1, k2 = R.split(k)
    emb = np.float32(1.0 / dim ** 0.5) * R.truncated_normal(k1, -2.0, 2.0,
                                                            (v, dim))
    return np.concatenate([emb, _glorot_uniform(k2, (v, 1))], axis=1)


def _split_engine(k, criteo: CriteoConfig, cfg: ModelConfig) -> dict:
    vocabs = criteo.field_vocab_sizes
    small = tuple(v for v in vocabs if v <= cfg.split_threshold)
    big = tuple(v for v in vocabs if v > cfg.split_threshold)
    k1, k2 = R.split(k)
    tables: dict = {}
    if small:
        tables["small"] = _fused_table(k1, small, cfg.embedding_dim)
    if big:
        tables["big_wm"] = np.ascontiguousarray(
            _fused_table(k2, big, cfg.embedding_dim).T)
    tables["b"] = np.zeros((), np.float32)
    return tables


def _mlp(k, in_dim: int, layers: tuple[int, ...], use_bn: bool):
    params: dict = {"layers": []}
    state: dict = {"layers": []}
    d = in_dim
    for h in layers:
        k, sub = R.split(k)
        layer_p: dict = {"dense": _dense(sub, d, h)}
        layer_s: dict = {}
        if use_bn:
            layer_p["bn"] = {"scale": np.ones((h,), np.float32),
                             "offset": np.zeros((h,), np.float32)}
            layer_s["bn"] = {"mean": np.zeros((h,), np.float32),
                             "var": np.ones((h,), np.float32)}
        params["layers"].append(layer_p)
        state["layers"].append(layer_s)
        d = h
    return params, state


def _cross(k, dim: int, num_layers: int) -> list:
    out = []
    for _ in range(num_layers):
        k, kw, kb = R.split(k, 3)
        out.append({"w": _glorot_normal_1d(kw, dim),
                    "b": _glorot_normal_1d(kb, dim)})
    return out


def _cin(k, num_fields: int, layers: tuple[int, ...]) -> list:
    out = []
    fk = num_fields
    for h in layers:
        k, sub = R.split(k)
        out.append({"w": _glorot_uniform(sub, (fk * num_fields, h)),
                    "b": np.zeros((h,), np.float32)})
        fk = h
    return out


def init_params(name: str, criteo: CriteoConfig, cfg: ModelConfig,
                seed: int):
    """(params, model_state) of the JAX package's
    ``create_train_state(make_model(name, criteo, cfg), seed)``, numpy in
    the JAX layout (``convert.convert_params`` takes them to the port)."""
    if name not in MODELS:
        raise ValueError(f"init_params: {name!r} is not one of {MODELS}")
    if name != "wide" and cfg.emb_engine != "split":
        raise ValueError(f"init_params: the {cfg.emb_engine!r} engine is "
                         "not replayed; only 'split'")
    k = R.split(R.key(seed))[0]                      # the init key
    n_fields = len(criteo.field_vocab_sizes)
    flat_dim = n_fields * cfg.embedding_dim
    if name == "wide":
        v = pad_rows(sum(criteo.field_vocab_sizes))
        return {"wide": {"w": _glorot_uniform(k, (v, 1))[:, 0],
                         "b": np.zeros((), np.float32)}}, {}
    if name == "fm":
        k1, k2 = R.split(k)
        return {"tables": _split_engine(k1, criteo, cfg),
                "final": _dense(k2, 2, 1)}, {}
    if name == "deepfm":
        k1, k2, k3, k4 = R.split(k, 4)
        dnn, dnn_s = _mlp(k2, flat_dim, cfg.deep_layers, cfg.use_bn)
        return {"tables": _split_engine(k1, criteo, cfg), "dnn": dnn,
                "dnn_out": _dense(k3, cfg.deep_layers[-1], 1),
                "final": _dense(k4, 3, 1)}, {"dnn": dnn_s}
    if name == "dcn":
        k1, k2, k3, k4 = R.split(k, 4)
        dnn, dnn_s = _mlp(k3, flat_dim, cfg.deep_layers, cfg.use_bn)
        return {"tables": _split_engine(k1, criteo, cfg),
                "cross": _cross(k2, flat_dim, cfg.cross_layers), "dnn": dnn,
                "final": _dense(k4, cfg.deep_layers[-1] + flat_dim, 1)}, \
            {"dnn": dnn_s}
    if name == "xdeepfm":
        ks = R.split(k, 7)
        dnn, dnn_s = _mlp(ks[5], flat_dim, cfg.deep_layers, cfg.use_bn)
        return {"tables": _split_engine(ks[0], criteo, cfg),
                "lin_dense": _dense(ks[1], len(criteo.cont_boundaries), 1),
                "cin": _cin(ks[3], n_fields, cfg.cin_layers),
                "cin_out": _dense(ks[4], sum(cfg.cin_layers), 1),
                "dnn": dnn, "dnn_out": _dense(ks[6], cfg.deep_layers[-1], 1),
                "final": _dense(R.fold_in(k, 7), 3, 1)}, {"dnn": dnn_s}
    k1, k2, k3 = R.split(k, 3)                       # dnn
    dnn, dnn_s = _mlp(k2, flat_dim, cfg.deep_layers, cfg.use_bn)
    return {"tables": _split_engine(k1, criteo, cfg), "dnn": dnn,
            "final": _dense(k3, cfg.deep_layers[-1], 1)}, {"dnn": dnn_s}
