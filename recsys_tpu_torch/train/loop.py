"""The fast-path training loop (counterpart of
``recsys_tpu/train/loop.py``'s ``train_and_evaluate_fast``): the dataset on
the device, K steps per host call, periodic eval with the streaming AUC,
logging of examples/s, and a checkpoint of ``(params, model_state,
opt_state)`` at every eval, from which a later run resumes.

Checkpoints are written in the JAX package's layout (`convert.export_params`
turns the big table back into ``big_wm``), so either package can resume
from the other's. The JSONL/TensorBoard summaries and best-metric
retention are not ported yet.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.core.config import TrainConfig
from recsys_tpu_torch.models.api import Model
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import train_state as TS

log = logging.getLogger("recsys_tpu_torch")


def _resume(ts, ckpt: CheckpointManager):
    """``ts`` with the latest checkpoint's trees copied in, or ``ts``."""
    template = convert.export_params((ts.params, ts.model_state,
                                      ts.opt_state))
    restored = ckpt.restore(template)
    if restored is None:
        return ts
    tree, step = restored
    device = ts.step.device
    with torch.no_grad():
        for dst, src in zip(
                tree_util.leaves((ts.params, ts.model_state, ts.opt_state)),
                tree_util.leaves(convert.convert_params(tree, device))):
            dst.copy_(src)
    log.info("resumed from step %d", step)
    return ts._replace(step=torch.tensor(step, dtype=torch.int32,
                                         device=device))


def train_and_evaluate_fast(model: Model, train_data: dict[str, np.ndarray],
                            eval_data: dict[str, np.ndarray],
                            cfg: TrainConfig, *, num_steps: int, device,
                            steps_per_call: int = 50,
                            resume: bool = True) -> dict[str, float]:
    """Train for ``num_steps`` on ``device`` with eval and a checkpoint every
    ``cfg.eval_every_steps`` and at the end; → the last eval's metrics plus
    ``train_seconds``, ``final_loss`` and ``examples_per_sec``."""
    ts, tx = TS.create_train_state(model, cfg.seed, cfg.learning_rate,
                                   device)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)
    if resume:
        ts = _resume(ts, ckpt)
    done = int(ts.step)

    staged_train = fast.stage_dataset(train_data, device)
    staged_eval = fast.stage_dataset(eval_data, device)
    n_train = len(train_data["label"])
    n_eval = len(eval_data["label"])
    step_fn = fast.make_scanned_train_step_devgen(model, tx, n_train,
                                                  cfg.batch_size)
    eval_fn = fast.make_scanned_eval(model)

    def run_eval():
        bs = min(cfg.batch_size, n_eval)
        # sequential coverage of the eval set, truncated (never wrapped:
        # wrapping would count examples twice in the streaming metrics)
        n_batches = min(cfg.eval_steps, max(1, n_eval // bs))
        idx = np.arange(n_batches * bs).reshape(n_batches, bs)
        mstate = eval_fn(ts.params, ts.model_state, staged_eval, idx,
                         M.init_binary_metrics(device=device))
        return M.finalize_binary_metrics(mstate)

    t0 = time.time()
    window_t0, window_steps = t0, done
    metrics: dict[str, float] = {}
    loss_v, rate = float("nan"), float("nan")
    next_eval = (done // cfg.eval_every_steps + 1) * cfg.eval_every_steps
    while done < num_steps:
        k = min(steps_per_call, num_steps - done, max(1, next_eval - done))
        ts, loss = step_fn(ts, staged_train, k)
        done += k
        if done >= next_eval or done >= num_steps:
            loss_v = float(loss)
            now = time.time()
            rate = (done - window_steps) / max(now - window_t0, 1e-9)
            log.info("step %d loss %.5f  %.1f steps/s  %.0f ex/s", done,
                     loss_v, rate, rate * cfg.batch_size)
            window_t0, window_steps = now, done
            metrics = run_eval()
            log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f", done,
                     metrics["auc"], metrics["logloss"], metrics["accuracy"])
            ckpt.save(done, convert.export_params(
                (ts.params, ts.model_state, ts.opt_state)),
                metric=metrics["auc"])
            next_eval += cfg.eval_every_steps
    metrics["train_seconds"] = time.time() - t0
    metrics["final_loss"] = loss_v
    metrics["examples_per_sec"] = rate * cfg.batch_size
    return metrics
