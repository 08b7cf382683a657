"""Straight-line NumPy inference for latency serving on the host
(counterpart of ``recsys_tpu/serve/numpy_engine.py``).

At the small batches of latency serving, a forward of the CTR zoo is a few
MFLOP: launched op by op it costs the host more than the work. This engine
runs the same inference math (`models/ctr.py`'s apply bodies with
``train=False``) as a few numpy/BLAS calls on read-only arrays, with batch
norm folded into one affine per layer at load time: no device, no
padding, safe from any number of threads.

It reads the PORT's parameter layout, as the port's `Servable` holds it,
brought to numpy: the split engine's row-major ``small`` and ``big``
tables ``[V_pad, D+1]``, the fused engine's ``table_flat`` seen as
``[V_pad, D+1]``, and the wide model's ``wide/w``. Embeddings come out in
the ENGINE field order (small fields, then big), as the dense layers and
CIN filters expect.

Models: fm, deepfm, dnn, dcn, xdeepfm and wide. DIN raises
``NotImplementedError``, as in the JAX package: it stays on the device
path.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import (CriteoConfig, EmbeddingConfig,
                                          ModelConfig)
from recsys_tpu_torch.embeddings import engines
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.ops.nn import BN_EPS

MODELS = ("fm", "deepfm", "dnn", "dcn", "xdeepfm", "wide")


def _np(tree):
    """A tree of tensors (on any device) or arrays → contiguous numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(tree))


def _fold_mlp(mlp_params: dict, mlp_state: dict) -> list[dict]:
    """[dense → relu → BN] × L, the inference BN folded to h·a + c."""
    layers = []
    for i, lp in enumerate(mlp_params["layers"]):
        layer = {"w": lp["dense"]["w"], "b": lp["dense"]["b"]}
        if "bn" in lp:
            ls = mlp_state["layers"][i]["bn"]
            a = lp["bn"]["scale"] / np.sqrt(ls["var"] + BN_EPS)
            layer["bn_a"] = a.astype(np.float32)
            layer["bn_c"] = (lp["bn"]["offset"] - ls["mean"] * a).astype(
                np.float32)
        layers.append(layer)
    return layers


def _sigmoid_(logits: np.ndarray) -> np.ndarray:
    """In-place sigmoid of a fresh logits array."""
    np.negative(logits, out=logits)
    np.exp(logits, out=logits)
    logits += 1.0
    np.reciprocal(logits, out=logits)
    return logits


def _mlp(layers: list[dict], x: np.ndarray) -> np.ndarray:
    """The tower, with the tail ops in place on each layer's fresh product:
    one allocation a layer."""
    h = x
    for layer in layers:
        h = np.dot(h, layer["w"])
        h += layer["b"]
        np.maximum(h, 0.0, out=h)
        if "bn_a" in layer:
            h *= layer["bn_a"]
            h += layer["bn_c"]
    return h


def _dense(p: dict, x: np.ndarray, relu: bool = False) -> np.ndarray:
    y = np.dot(x, p["w"])
    y += p["b"]
    if relu:
        np.maximum(y, 0.0, out=y)
    return y


class NumpyPredictor:
    """``probs = predictor(features)`` as straight-line numpy over the
    port's parameters (``params``/``state``: tensors on any device, or
    arrays)."""

    def __init__(self, model_name: str, criteo_cfg: CriteoConfig,
                 model_cfg: ModelConfig, params, state):
        if model_name not in MODELS:
            raise NotImplementedError(
                f"the numpy engine serves the CTR zoo {MODELS}, not "
                f"{model_name!r}")
        self.name = model_name
        p, s = _np(params), _np(state)
        self.p = p
        if model_name == "wide":
            self.offsets = emb_table.field_offsets(
                criteo_cfg.field_vocab_sizes).astype(np.int64)
            self.w_wide, self.b_wide = p["wide"]["w"], p["wide"]["b"]
            return

        engine = engines.make_engine(
            EmbeddingConfig(field_vocab_sizes=criteo_cfg.field_vocab_sizes,
                            embedding_dim=model_cfg.embedding_dim),
            model_cfg.emb_engine, threshold=model_cfg.split_threshold)
        tables = p["tables"]
        self.b_tab = tables["b"]
        self.field_order = engine.field_order
        if "table_flat" in tables:                       # fused engine
            self.parts = [{
                "rows": tables["table_flat"].reshape(engine.v_pad,
                                                     engine.width),
                "offsets": engine.offsets.astype(np.int64),
                "fields": np.arange(len(criteo_cfg.field_vocab_sizes))}]
        else:                                            # split engine
            self.parts = []
            for name, fields in zip(("small", "big"), engine._partition()):
                if fields:
                    self.parts.append({
                        "rows": tables[name],            # [V_pad, D+1]
                        "offsets": emb_table.field_offsets(
                            engine._sizes(fields)).astype(np.int64),
                        "fields": np.asarray(fields)})
        if model_name in ("deepfm", "dnn", "dcn", "xdeepfm"):
            self.mlp = _fold_mlp(p["dnn"], s["dnn"])
        if model_name == "xdeepfm":
            n_cont = len(criteo_cfg.cont_boundaries)
            self.cat_pos = np.where(self.field_order >= n_cont)[0]

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        """[B, F, D+1] rows in engine field order."""
        rows = [part["rows"][ids[:, part["fields"]].astype(np.int64)
                             + part["offsets"]] for part in self.parts]
        return rows[0] if len(rows) == 1 else np.concatenate(rows, axis=1)

    def __call__(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features (``ids`` [B, 39], ``dense`` [B, 13]) → probs [B]
        float32."""
        ids = np.asarray(features["ids"])
        if self.name == "wide":
            gids = ids.astype(np.int64) + self.offsets
            return _sigmoid_(self.w_wide[gids].sum(axis=1) + self.b_wide)

        rows = self._rows(ids)
        emb, wide = rows[:, :, :-1], rows[:, :, -1]
        b, f, d = emb.shape
        emb2d = emb.reshape(b, f * d)
        p = self.p
        if self.name in ("fm", "deepfm"):
            y1 = np.maximum(wide.sum(1, keepdims=True) + self.b_tab, 0.0)
            ys = [y1, self._fm(emb)]
            if self.name == "deepfm":
                ys.append(_dense(p["dnn_out"], _mlp(self.mlp, emb2d),
                                 relu=True))
            logits = _dense(p["final"], np.concatenate(ys, 1))
        elif self.name == "dnn":
            logits = _dense(p["final"], _mlp(self.mlp, emb2d))
        elif self.name == "dcn":
            xl = emb2d
            for layer in p["cross"]:
                xl = (xl @ layer["w"])[:, None] * emb2d + xl + layer["b"]
            logits = _dense(p["final"],
                            np.concatenate([_mlp(self.mlp, emb2d), xl], 1))
        else:                                            # xdeepfm
            dense_vals = np.asarray(features["dense"], np.float32)
            lin = (_dense(p["lin_dense"], dense_vals)
                   + wide[:, self.cat_pos].sum(1, keepdims=True))
            y_cin = _dense(p["cin_out"], self._cin(emb), relu=True)
            y_dnn = _dense(p["dnn_out"], _mlp(self.mlp, emb2d), relu=True)
            logits = _dense(p["final"], np.concatenate(
                [np.maximum(lin, 0.0), y_cin, y_dnn], 1))
        return _sigmoid_(logits[:, 0])

    @staticmethod
    def _fm(emb: np.ndarray) -> np.ndarray:
        s = emb.sum(axis=1)
        y = np.einsum("bd,bd->b", s, s)
        y -= np.einsum("bfd,bfd->b", emb, emb)
        y *= 0.5
        return y[:, None]

    def _cin(self, emb: np.ndarray) -> np.ndarray:
        """The CIN with feature maps carried as [B·D, F] (the embedding dim
        fused into the rows), so z is one broadcast product a layer."""
        b, f0, d = emb.shape
        x0 = np.transpose(emb, (0, 2, 1)).reshape(b * d, f0)
        xk = x0
        pooled = []
        for layer in self.p["cin"]:
            fk = xk.shape[1]
            z = (x0[:, :, None] * xk[:, None, :]).reshape(b * d, f0 * fk)
            xk = np.maximum(z @ layer["w"] + layer["b"], 0.0)   # [B·D, H]
            pooled.append(xk.reshape(b, d, -1).sum(axis=1))     # [B, H]
        return np.concatenate(pooled, axis=1)
