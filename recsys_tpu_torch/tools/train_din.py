"""DIN command line (counterpart of ``recsys_tpu/tools/train_din.py``):
tasks ``train``, ``eval``, ``predict``, ``export`` and ``serve`` for the
Deep Interest Network.

    python -m recsys_tpu_torch.tools.train_din train --device=cuda \
        --train.batch_size=1024 --train.num_steps=2000 [--data=examples.npz]
    python -m recsys_tpu_torch.tools.train_din export --export_dir=./export_din
    python -m recsys_tpu_torch.tools.train_din serve \
        --export_dir=./export_din --device=cuda --port=8500

The flags are the JAX command's: every ``--section.key=value`` of the run
config (the model defaults to DIN with embedding dim 32, no batch norm and
dropout 0.1), ``--data=<path.npz>`` (a dataset saved with
`amazon.save_din_npz`), or, without it, the planted synthetic task
`amazon.synthetic_din_hard` of ``--synthetic_users`` users over
``--item_vocab`` items and ``--cate_vocab`` categories. The last tenth of
the examples is held out for eval. ``--device`` is ``cuda`` (the default;
it fails without a card and never falls back) or ``cpu``.

``train`` runs `loop.train_and_evaluate` (host-fed batches through
`loader.device_prefetch`, on the card each step one CUDA-graph replay;
periodic eval, checkpoints under ``--train.model_dir``, resume from the
latest one).
``eval``, ``predict`` and ``export`` restore the latest checkpoint (fresh
weights if there is none); ``export`` writes a servable that either
package loads. ``serve`` is ``tools/train_ctr.py serve``: one serving stack
for every model.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys

if __name__ == "__main__" and sys.argv[1:2] == ["serve"]:
    # as `train_ctr serve`: one BLAS thread, set before numpy loads it
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np
import torch

from recsys_tpu_torch.core.config import (ModelConfig, RunConfig,
                                          apply_overrides)
from recsys_tpu_torch.data import amazon
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import train_ctr
from recsys_tpu_torch.train import fast, loop
from recsys_tpu_torch.train import train_state as TS

_TASKS = ("train", "eval", "predict", "export", "serve")
_FLAT = ("data", "export_dir", "port", "device", "synthetic_users",
         "item_vocab", "cate_vocab")


def _parse(argv: list[str]):
    """→ (task, flat flags, ``--section.key=value`` overrides)."""
    task = argv[0] if argv and not argv[0].startswith("--") else "train"
    flat, overrides = {}, []
    for a in argv[1 if argv and argv[0] == task else 0:]:
        key, eq, value = a[2:].partition("=")
        if not a.startswith("--") or not eq or (
                "." not in key and key not in _FLAT):
            raise SystemExit(f"unsupported argument {a!r}; train_din takes "
                             f"--section.key=value and "
                             f"--{'=, --'.join(_FLAT)}=")
        if "." in key:
            overrides.append(a)
        else:
            flat[key] = value
    return task, flat, overrides


def _load_dataset(kv: dict) -> amazon.DinDataset:
    if "data" in kv:
        return amazon.load_din_npz(kv["data"])
    return amazon.synthetic_din_hard(
        n_users=int(kv.get("synthetic_users", 40_000)),
        item_vocab=int(kv.get("item_vocab", 2000)),
        cate_vocab=int(kv.get("cate_vocab", 40)))


def split_dataset(ds: amazon.DinDataset, holdout_frac: float = 0.1):
    """Deterministic example-level split on an even boundary, so each
    user's positive and negative stay together and both halves are
    label-balanced."""
    n = len(ds.label)
    hold = max(2, int(n * holdout_frac) // 2 * 2)
    data = {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
            "hist_cate": ds.hist_cate, "label": ds.label}
    return ({k: v[:-hold] for k, v in data.items()},
            {k: v[-hold:] for k, v in data.items()})


def batch_iter(data: dict, batch_size: int, seed: int, num_epochs: int = -1):
    """Shuffled host batches, a new permutation each epoch, the remainder
    dropped (the JAX command's order for the same seed)."""
    n = len(data["label"])
    epoch = 0
    while num_epochs < 0 or epoch < num_epochs:
        order = np.random.default_rng([seed, epoch]).permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            yield {k: v[idx] for k, v in data.items()}
        epoch += 1


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["serve"]:       # with train_ctr serve's flags
        return train_ctr.main(argv)
    task, kv, overrides = _parse(argv)
    if task not in _TASKS:
        raise SystemExit(f"unknown task {task}")

    base = dataclasses.replace(
        RunConfig(), model=ModelConfig(name="din", embedding_dim=32,
                                       use_bn=False, dropout=0.1))
    try:
        cfg = apply_overrides(base, overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    device = train_ctr.device_from_flag(kv.get("device", "cuda"))
    ds = _load_dataset(kv)
    model = make_model("din", ds.item_vocab, ds.cate_vocab, cfg.model)
    train_data, eval_data = split_dataset(ds)
    bs = min(cfg.train.batch_size, len(eval_data["label"]))

    def eval_batches():
        return batch_iter(eval_data, bs, seed=0, num_epochs=1)

    if task == "train":
        num_steps = cfg.train.num_steps
        if num_steps < 0:
            num_steps = (cfg.train.num_epochs * len(train_data["label"])
                         // cfg.train.batch_size)
        metrics = loop.train_and_evaluate(
            model, batch_iter(train_data, cfg.train.batch_size,
                               cfg.train.seed),
            eval_batches, cfg.train, num_steps=num_steps, device=device)
        print(metrics, flush=True)
        return metrics

    # eval / predict / export restore the trained weights
    ts = loop.restored_state(model, cfg.train, device)

    if task == "eval":
        metrics = loop.evaluate(model, ts.params, ts.model_state,
                                eval_batches(), device=device,
                                max_steps=cfg.train.eval_steps * 10)
        print(metrics, flush=True)
        return metrics
    if task == "predict":
        predict = TS.make_predict_step(model)
        with torch.inference_mode():
            probs = [predict(ts.params, ts.model_state,
                             fast.stage_dataset(b, device)).cpu().numpy()
                     for b in eval_batches()]
        out = np.concatenate(probs)
        print({"num_predictions": len(out), "mean_prob": float(out.mean())},
              flush=True)
        return {"probs": out}
    from recsys_tpu_torch.serve.export import export_servable
    d = export_servable(
        kv.get("export_dir", "./export_din"), "din", ts.params,
        ts.model_state, cfg.model, criteo_cfg=None,
        factory_kwargs={"item_vocab": ds.item_vocab,
                        "cate_vocab": ds.cate_vocab})
    print({"export_dir": d}, flush=True)
    return {"export_dir": d}


if __name__ == "__main__":
    main()
