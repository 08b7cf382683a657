"""Model export for serving (counterpart of ``recsys_tpu/serve/export.py``).

A servable is a directory with ``servable.json`` (model name and configs)
and a checkpoint ``step_0`` holding ``(params, model_state)``, both in the
JAX package's format and layout: a servable exported by either package
loads in the other. ``prob = predict(features)`` is the serving signature.

As in the JAX package, a request is padded to a batch bucket
(`DEFAULT_BUCKETS`): to the smallest bucket that holds it, or beyond the
largest to a multiple of the largest, by repeating its last row, and the
answer is cut back to the request's rows. On the card each padded
signature (every feature's name, shape and type) is one CUDA graph of the
predict step, captured once and replayed from static input buffers: one
graph launch a request, where the eager step launches its 100-odd
kernels one by one from Python. ``engine='numpy'`` serves the CTR zoo
through `numpy_engine.NumpyPredictor` on the host instead: no device, no
padding.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train import step_graph
from recsys_tpu_torch.train.train_state import make_predict_step

DEFAULT_BUCKETS = (1, 8, 64, 256, 1024, 4096)


def export_servable(export_dir: str, model_name: str, params, model_state,
                    model_cfg: ModelConfig,
                    criteo_cfg: CriteoConfig | None = None,
                    extra: dict | None = None,
                    factory_kwargs: dict | None = None) -> str:
    """Write port ``params``/``model_state`` as a servable in the JAX
    layout (``convert.export_params``), ``extra`` into the checkpoint's
    meta. ``factory_kwargs`` go to the model factory at load time (DIN's
    ``item_vocab``/``cate_vocab``), so the rebuilt parameter shapes match
    the exported weights."""
    os.makedirs(export_dir, exist_ok=True)
    mgr = checkpoint.CheckpointManager(export_dir, keep_max=1)
    mgr.save(0, (convert.export_params(params),
                 convert.export_params(model_state)), extra=extra)
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


class _BucketGraph:
    """The graph of one padded signature, and the lock its caller holds
    from copying its rows into the static buffers to having the answer on
    the host."""

    def __init__(self, name: str):
        self.graph = step_graph.StepGraph(name)
        self.lock = threading.Lock()


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

    ``buckets``: the padded batch sizes, as in the JAX package.
    ``engine``: ``'jit'`` (the device path; the JAX command line's name
    for it) or ``'numpy'`` (`numpy_engine.NumpyPredictor` on the host, the
    CTR zoo only). ``graphed``: whether the device path replays one CUDA
    graph per padded signature; by default on the card, and eagerly
    (``False``) at the same padded shapes. ``True`` off the card raises. A
    capture or replay that fails raises, naming the servable and the
    signature; nothing runs eagerly in its place.

    Thread-safety contract: `predict` MUST be safe to call concurrently
    from several threads; the server's micro-batcher runs it on the
    caller's thread while its worker may run a coalesced batch. It is: the
    parameters are read-only after load; an eager call allocates its own
    tensors under ``torch.inference_mode()``; a graphed call holds its
    signature's lock from copying its rows into the graph's static buffers,
    through the replay, to its answer being on the host, so two callers
    never share a buffer (calls of other signatures run meanwhile), and a
    capture holds it too. Captures run in CUDA's thread_local mode, so
    other threads' CUDA work goes on beside one. The kernels' launch
    counters are updated under their wrappers' locks.
    """

    def __init__(self, export_dir: str, device: str = "cuda",
                 buckets: tuple[int, ...] = DEFAULT_BUCKETS,
                 engine: str = "jit", graphed: bool | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Servable(device='cuda'): no CUDA device is "
                               "available")
        if engine not in ("jit", "numpy"):
            raise ValueError(f"engine {engine!r}: want 'jit' or 'numpy'")
        if not buckets or min(buckets) < 1:
            raise ValueError(f"buckets {buckets}: want positive sizes")
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.engine = engine
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
        tree, _, _ = restored
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
        self._np_predict = None
        if engine == "numpy":
            from recsys_tpu_torch.serve.numpy_engine import NumpyPredictor
            self._np_predict = NumpyPredictor(
                self.model_name, self.criteo_cfg, model_cfg, self.params,
                self.model_state)
        self._name = f"Servable({self.model_name}, {export_dir})"
        self.graphed = step_graph.use_graph(graphed, self.device, self._name)
        #: padded signature → its graph; and the captures taken so far
        self._graphs: dict[tuple, _BucketGraph] = {}
        self._graphs_lock = threading.Lock()
        self.captures = 0

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

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return (n + top - 1) // top * top

    @staticmethod
    def _pad(features: dict[str, np.ndarray], b: int) -> dict:
        """`check`ed features as the device takes them (ids int64), padded
        to ``b`` rows by repeating the last row (a checked row, so every
        padded id is in range)."""
        out = {}
        for k, v in features.items():
            if v.dtype.kind in "iu":
                v = v.astype(np.int64)
            if b > len(v):
                v = np.concatenate([v, np.repeat(v[-1:], b - len(v), 0)])
            out[k] = np.ascontiguousarray(v)
        return out

    @staticmethod
    def _sig(padded: dict) -> tuple:
        return tuple(sorted((k, v.shape, v.dtype.str)
                            for k, v in padded.items()))

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        """features → probs [B] float32 (the "prob" serving output)."""
        features = self.check(features)
        if self._np_predict is not None:
            return np.asarray(self._np_predict(features), np.float32)
        n = len(next(iter(features.values())))
        if n == 0:
            return np.zeros((0,), np.float32)
        padded = self._pad(features, self._bucket(n))
        with torch.inference_mode():
            if self.graphed:
                return self._replay(padded)[:n]
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in padded.items()}
            probs = self._predict(self.params, self.model_state, batch)
            return probs.float().cpu().numpy()[:n]

    def _replay(self, padded: dict) -> np.ndarray:
        """The padded request through its signature's graph, captured on
        the signature's first request (whose answer is the capture's
        warm-up run)."""
        sig = self._sig(padded)
        with self._graphs_lock:
            entry = self._graphs.get(sig)
            if entry is None:
                entry = self._graphs[sig] = _BucketGraph(
                    f"{self._name} signature {sig}")
        held = (self.params, self.model_state)
        with entry.lock:
            static = entry.graph.static_for(held)
            fresh = static is None
            if fresh:   # (probs, input buffers): the capture reads the
                # device of static[0]
                rows = len(next(iter(padded.values())))
                static = (torch.empty(rows, dtype=torch.float32,
                                      device=self.device),
                          {k: torch.empty(v.shape,
                                          dtype=torch.from_numpy(v).dtype,
                                          device=self.device)
                           for k, v in padded.items()})
            for k, v in padded.items():
                static[1][k].copy_(torch.from_numpy(v))
            if fresh:
                entry.graph.capture(held, static, lambda: static[0].copy_(
                    self._predict(self.params, self.model_state, static[1])))
                with self._graphs_lock:
                    self.captures += 1
            else:
                entry.graph.replay()
            # a copy: the buffer is the next caller's once the lock is free
            return static[0].to("cpu", copy=True).numpy()

    def _sample_features(self, n: int) -> dict[str, np.ndarray]:
        """A synthetic request of ``n`` rows: Criteo rows, or what the
        model's ``meta['sample_features']`` makes (DIN)."""
        if self.criteo_cfg is not None:
            from recsys_tpu_torch.data.criteo import synthetic_criteo
            d = synthetic_criteo(n, self.criteo_cfg)
            return {"ids": d["ids"], "dense": d["dense"]}
        return self.model.meta["sample_features"](n)

    def warmup(self) -> None:
        """One synthetic request at every bucket, so no client pays the
        kernels' build or a capture: on the card it captures each bucket's
        graph. The numpy engine has nothing to warm up."""
        if self._np_predict is not None:
            return
        sample = self._sample_features(1)
        for b in self.buckets:
            self.predict({k: np.repeat(v, b, axis=0)
                          for k, v in sample.items()})
