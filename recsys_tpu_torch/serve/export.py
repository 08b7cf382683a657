"""Model export for serving (counterpart of ``recsys_tpu/serve/export.py``).

A servable is a directory with ``servable.json`` (model name and configs)
and a checkpoint ``step_0`` holding ``(params, model_state)``, both in the
JAX package's format and layout: a servable exported by either package
loads in the other. ``prob = predict(features)`` is the serving signature.

The port runs eagerly, so it needs no batch-size buckets and no padding:
each request runs at its own batch size.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train.train_state import make_predict_step


def export_servable(export_dir: str, model_name: str, params, model_state,
                    model_cfg: ModelConfig,
                    criteo_cfg: CriteoConfig | None = None,
                    factory_kwargs: dict | None = None) -> str:
    """Write port ``params``/``model_state`` as a servable in the JAX
    layout (``convert.export_params``). ``factory_kwargs`` go to the model
    factory at load time (DIN's ``item_vocab``/``cate_vocab``), so the
    rebuilt parameter shapes match the exported weights."""
    os.makedirs(export_dir, exist_ok=True)
    mgr = checkpoint.CheckpointManager(export_dir, keep_max=1)
    mgr.save(0, (convert.export_params(params),
                 convert.export_params(model_state)))
    meta = {
        "model_name": model_name,
        "model_cfg": dataclasses.asdict(model_cfg),
        "criteo_cfg": dataclasses.asdict(criteo_cfg) if criteo_cfg else None,
        "factory_kwargs": factory_kwargs or {},
    }
    with open(os.path.join(export_dir, "servable.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return export_dir


def _cfg_from_dict(cls, d):
    if d is None:
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return cls(**kw)


def _check_like(template, tree) -> list:
    """Leaves of ``tree`` after checking them, in flatten order, against
    ``template``'s paths, shapes and dtypes. A silent cast or reshape would
    hide a config or model-version mismatch, so any difference raises."""
    want, got = checkpoint.flatten(template), checkpoint.flatten(tree)
    if [p for p, _ in want] != [p for p, _ in got]:
        raise ValueError(
            f"checkpoint leaves {[p for p, _ in got]} do not match the "
            f"model's {[p for p, _ in want]}")
    for (path, t), (_, leaf) in zip(want, got):
        if leaf.shape != t.shape or leaf.dtype != t.dtype:
            raise ValueError(
                f"checkpoint leaf {path}: {leaf.dtype}{tuple(leaf.shape)} != "
                f"model {t.dtype}{tuple(t.shape)}")
    return [leaf for _, leaf in got]


class Servable:
    """Loaded inference endpoint on one device.

    The Criteo models (the whole zoo, on either engine) and DIN are
    ported; another model's servable raises ``NotImplementedError``. The
    device is the card unless the caller asks for ``device='cpu'``:
    ``cuda`` without a card raises, it never falls back to the CPU. On the
    card the table reads run through the row-gather kernel
    (``ops.row_gather``) and xDeepFM's CIN layers through the CIN kernel
    (``ops.cin_kernel``), on the CPU through their plain versions. Every
    id of a request is checked on the host against its table (`check`):
    one out of range is a ``ValueError`` (a 400 from the server) and never
    reaches a gather.

    Thread-safety contract: `predict` MUST be safe to call concurrently
    from several threads; the server's micro-batcher runs it on the
    caller's thread while its worker may run a coalesced batch. It is: the
    parameters are read-only after load, each call allocates its own
    tensors under ``torch.inference_mode()``, and the only state shared
    between calls is the kernels' launch counters, which their wrappers
    update under a lock.
    """

    def __init__(self, export_dir: str, device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Servable(device='cuda'): no CUDA device is "
                               "available")
        with open(os.path.join(export_dir, "servable.json")) as f:
            meta = json.load(f)
        self.model_name = meta["model_name"]
        model_cfg = _cfg_from_dict(ModelConfig, meta["model_cfg"])
        self.criteo_cfg = _cfg_from_dict(CriteoConfig, meta["criteo_cfg"])
        kwargs = meta.get("factory_kwargs") or {}
        if self.criteo_cfg is not None and not kwargs:
            self.model = make_model(self.model_name, self.criteo_cfg,
                                    model_cfg)
        elif self.criteo_cfg is None and self.model_name == "din":
            self.model = make_model(self.model_name, cfg=model_cfg, **kwargs)
        else:
            raise NotImplementedError(
                f"servable {self.model_name!r}: only the Criteo models and "
                "DIN are ported")
        restored = checkpoint.CheckpointManager(export_dir).restore()
        if restored is None:
            raise FileNotFoundError(f"no weights in {export_dir}")
        tree, _ = restored
        # shapes only: the meta device allocates and draws nothing
        template = list(self.model.init(torch.Generator(), "meta"))
        loaded = convert.convert_params(tree, self.device)
        self.params, self.model_state = tree_util.fill_like(
            template, _check_like(template, loaded))
        if self.criteo_cfg is not None:
            self._vocab = np.asarray(self.criteo_cfg.field_vocab_sizes)
        else:
            items = self.params["item_emb"].shape[0]
            cates = self.params["cate_emb"].shape[0]
            self._vocab = {"i_id": items, "i_cate": cates,
                           "hist_iid": items, "hist_cate": cates}
        self._predict = make_predict_step(self.model)

    def _check_din(self, features: dict[str, np.ndarray]) -> dict:
        """DIN's four features, checked: ``i_id``/``i_cate`` [B],
        ``hist_iid``/``hist_cate`` [B, P] with P ≥ 1, integers within their
        table's vocab."""
        out = {}
        for name, vocab in self._vocab.items():
            if name not in features:
                raise ValueError(f"DIN request without feature {name!r}")
            v = np.asarray(features[name])
            want = 1 if name.startswith("i_") else 2
            if v.ndim != want or (want == 2 and v.shape[1] < 1):
                raise ValueError(f"{name} shape {v.shape}, want "
                                 + ("[B]" if want == 1 else "[B, P ≥ 1]"))
            if v.dtype.kind not in "iu" or (
                    v.size and (v.min() < 0 or v.max() >= vocab)):
                raise ValueError(f"{name} must be integers in [0, {vocab})")
            out[name] = v
        shapes = {k: v.shape for k, v in out.items()}
        if len({s[0] for s in shapes.values()}) != 1 or \
                shapes["hist_iid"] != shapes["hist_cate"]:
            raise ValueError(f"DIN feature shapes {shapes} do not agree")
        return out

    def check(self, features: dict[str, np.ndarray]) -> dict:
        """The request's features as numpy arrays, checked on the host:
        names, shapes, and integer ids within their tables (an id out of
        range is a ``ValueError`` and never reaches a gather). `predict`
        runs it before every device call, and the server's micro-batcher on
        each caller's thread before it queues the request, so a bad request
        fails alone."""
        if self.criteo_cfg is None:
            return self._check_din(features)
        ids = np.asarray(features["ids"])
        # RAW1 bodies arrive as read-only views; torch wants writable memory
        dense = np.require(features["dense"], np.float32, ["C", "W"])
        if ids.ndim != 2 or ids.shape[1] != len(self._vocab):
            raise ValueError(f"ids shape {ids.shape}, want [B, "
                             f"{len(self._vocab)}]")
        if dense.ndim != 2 or dense.shape[0] != ids.shape[0]:
            raise ValueError(f"dense shape {dense.shape} does not match ids "
                             f"{ids.shape}")
        # an id out of range never reaches a gather (the card's would answer
        # with a zero row, the CPU's raise)
        if ids.dtype.kind not in "iu" or (
                ids.size and (ids.min() < 0 or (ids >= self._vocab).any())):
            raise ValueError("ids must be integers in [0, field vocab)")
        return {"ids": ids, "dense": dense}

    def _batch(self, features: dict[str, np.ndarray]) -> dict:
        """`check`ed features as tensors on the device, ids as int64."""
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu"
                                    else v).to(self.device)
                for k, v in self.check(features).items()}

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features → probs [B] float32 (the "prob" serving output)."""
        with torch.inference_mode():
            probs = self._predict(self.params, self.model_state,
                                  self._batch(features))
            return probs.float().cpu().numpy()

    def _sample_features(self, n: int) -> dict[str, np.ndarray]:
        """A synthetic request of ``n`` rows: Criteo rows, or what the
        model's ``meta['sample_features']`` makes (DIN)."""
        if self.criteo_cfg is not None:
            from recsys_tpu_torch.data.criteo import synthetic_criteo
            d = synthetic_criteo(n, self.criteo_cfg)
            return {"ids": d["ids"], "dense": d["dense"]}
        return self.model.meta["sample_features"](n)

    def warmup(self) -> None:
        """One request of batch 1, so the first client does not pay the
        kernel build."""
        self.predict(self._sample_features(1))
