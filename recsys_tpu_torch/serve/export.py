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
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train.train_state import make_predict_step


def export_servable(export_dir: str, model_name: str, params, model_state,
                    model_cfg: ModelConfig, criteo_cfg: CriteoConfig) -> str:
    """Write port ``params``/``model_state`` as a servable in the JAX
    layout (``convert.export_params``)."""
    os.makedirs(export_dir, exist_ok=True)
    mgr = checkpoint.CheckpointManager(export_dir, keep_max=1)
    mgr.save(0, (convert.export_params(params),
                 convert.export_params(model_state)))
    meta = {
        "model_name": model_name,
        "model_cfg": dataclasses.asdict(model_cfg),
        "criteo_cfg": dataclasses.asdict(criteo_cfg),
        "factory_kwargs": {},
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

    ``device='cuda'`` needs a card and raises without one; it never falls
    back to the CPU. On the card the CIN layers run through the CUDA kernel
    (``ops.cin_kernel``), on the CPU through its plain version.

    Thread-safety contract: `predict` MUST be safe to call concurrently
    from several threads; the server's micro-batcher runs it on the
    caller's thread while its worker may run a coalesced batch. It is: the
    parameters are read-only after load, each call allocates its own
    tensors under ``torch.inference_mode()``, and the only state shared
    between calls is the kernel's launch counter, which its wrapper updates
    under a lock.
    """

    def __init__(self, export_dir: str, device: str = "cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Servable(device='cuda'): no CUDA device is "
                               "available")
        with open(os.path.join(export_dir, "servable.json")) as f:
            meta = json.load(f)
        self.model_name = meta["model_name"]
        model_cfg = _cfg_from_dict(ModelConfig, meta["model_cfg"])
        self.criteo_cfg = _cfg_from_dict(CriteoConfig, meta["criteo_cfg"])
        if self.criteo_cfg is None or meta.get("factory_kwargs"):
            raise NotImplementedError(
                f"servable {self.model_name!r}: only the Criteo models are "
                "ported")
        self.model = make_model(self.model_name, self.criteo_cfg, model_cfg)
        restored = checkpoint.CheckpointManager(export_dir).restore()
        if restored is None:
            raise FileNotFoundError(f"no weights in {export_dir}")
        tree, _ = restored
        # shapes only: the meta device allocates and draws nothing
        template = list(self.model.init(torch.Generator(), "meta"))
        loaded = convert.convert_params(tree, self.device)
        self.params, self.model_state = checkpoint.fill_like(
            template, _check_like(template, loaded))
        self._vocab = np.asarray(self.criteo_cfg.field_vocab_sizes)
        self._predict = make_predict_step(self.model)

    def _batch(self, features: dict[str, np.ndarray]) -> dict:
        ids = np.asarray(features["ids"])
        # RAW1 bodies arrive as read-only views; torch wants writable memory
        dense = np.require(features["dense"], np.float32, ["C", "W"])
        if ids.ndim != 2 or ids.shape[1] != len(self._vocab):
            raise ValueError(f"ids shape {ids.shape}, want [B, "
                             f"{len(self._vocab)}]")
        if dense.ndim != 2 or dense.shape[0] != ids.shape[0]:
            raise ValueError(f"dense shape {dense.shape} does not match ids "
                             f"{ids.shape}")
        # an out-of-range id would be a device-side fault in the gather
        if ids.dtype.kind not in "iu" or (
                ids.size and (ids.min() < 0 or (ids >= self._vocab).any())):
            raise ValueError("ids must be integers in [0, field vocab)")
        return {
            "ids": torch.from_numpy(ids.astype(np.int64)).to(self.device),
            "dense": torch.from_numpy(dense).to(self.device),
        }

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features → probs [B] float32 (the "prob" serving output)."""
        with torch.inference_mode():
            probs = self._predict(self.params, self.model_state,
                                  self._batch(features))
            return probs.float().cpu().numpy()

    def warmup(self) -> None:
        """One request of batch 1, so the first client does not pay the
        kernel build."""
        from recsys_tpu_torch.data.criteo import synthetic_criteo
        d = synthetic_criteo(1, self.criteo_cfg)
        self.predict({"ids": d["ids"], "dense": d["dense"]})
