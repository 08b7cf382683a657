"""Training loops (counterpart of ``recsys_tpu/train/loop.py``).

- `train_and_evaluate`: host-fed. Numpy batches from any host iterator
  (`loader.ShardSource` over shards, for a training set larger than the
  card, or DIN's batches) cross to the device through
  `loader.device_prefetch` (pinned buffers and a copy stream on the card,
  a batch ahead of the step), and each step is `fast.make_fed_train_step`:
  on the card one CUDA-graph replay. A log line of loss and examples/s
  every ``log_every_steps``, eval every ``eval_every_steps`` and at the
  end, a checkpoint at every eval and every ``save_checkpoints_steps``.
- `train_and_evaluate_fast`: the dataset on the device, K steps per host
  call (on the card each step and each eval batch one CUDA-graph replay,
  `fast`), eval and a checkpoint every ``eval_every_steps``.
- `evaluate`: one sweep of the streaming metrics over host batches, also
  through `device_prefetch`; its step runs eagerly.

Both loops resume from the latest checkpoint of ``(params, model_state,
opt_state)``. Every step draws its randomness from (``cfg.seed``, step)
(`train_state.reseed`), so a resumed run continues the run it resumes.
Checkpoints are written in the JAX package's layout
(`convert.export_params` turns the big table back into ``big_wm``), so
either package can resume from the other's. The JSONL/TensorBoard
summaries and best-metric retention are not ported yet.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.core.config import TrainConfig
from recsys_tpu_torch.data.loader import device_prefetch
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


def restored_state(model: Model, cfg: TrainConfig, device) -> TS.TrainState:
    """A train state with the latest checkpoint of ``cfg.model_dir`` copied
    in, or fresh weights (and a warning) when there is none: what
    ``eval``, ``predict`` and ``export`` of the command lines start from."""
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)
    ts, _ = TS.create_train_state(model, cfg.seed, cfg.learning_rate, device)
    if ckpt.latest_step() is None:
        log.warning("no checkpoint in %s; fresh params", cfg.model_dir)
    return _resume(ts, ckpt)


def evaluate(model: Model, params, model_state,
             eval_batches: Iterable[dict[str, np.ndarray]], *, device,
             max_steps: int | None = None) -> dict[str, float]:
    """One eval sweep over host batches on ``device`` (through
    `device_prefetch`) → {'auc', 'accuracy', 'logloss', 'count'}."""
    eval_step = TS.make_eval_step(model)
    mstate = M.init_binary_metrics(device=device)
    batches = device_prefetch(itertools.islice(eval_batches, max_steps),
                              device)
    try:
        for batch in batches:
            mstate = eval_step(params, model_state, mstate, batch)
    finally:
        batches.close()
    return M.finalize_binary_metrics(mstate)


def train_and_evaluate(model: Model, train_iter: Iterator[dict],
                       eval_batches_fn, cfg: TrainConfig, *, num_steps: int,
                       device, resume: bool = True) -> dict[str, float]:
    """Train for ``num_steps`` on ``device`` from host batches (numpy,
    drawn from ``train_iter`` through `device_prefetch`), with periodic
    eval and checkpoints. One batch is drawn from ``train_iter`` per step
    taken and none beyond the last step, so an iterator shared with a
    later call loses nothing. ``eval_batches_fn()`` returns a fresh finite
    iterable of eval batches. Each step is `fast.make_fed_train_step`'s,
    graphed on CUDA. → the last eval's metrics plus ``train_seconds``,
    ``first_loss`` and ``final_loss`` (the first and last logged losses)
    and ``examples_per_sec`` (the last log window's rate)."""
    ts, tx = TS.create_train_state(model, cfg.seed, cfg.learning_rate,
                                   device)
    step_fn = fast.make_fed_train_step(model, tx)
    ckpt = CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)
    if resume:
        ts = _resume(ts, ckpt)
    start_step = int(ts.step)

    t0 = time.time()
    window_t0, window_step = t0, start_step
    losses: list[float] = []
    ex_s = float("nan")
    metrics: dict[str, float] = {}
    # the prefetch threads read ahead: hand them exactly the steps' batches
    batches = device_prefetch(
        itertools.islice(train_iter, max(0, num_steps - start_step)), device)
    try:
        for step_idx in range(start_step, num_steps):
            batch = next(batches)
            loss = step_fn(ts, batch, step_idx)
            if (step_idx + 1) % cfg.log_every_steps == 0:
                losses.append(float(loss))    # the one host read per window
                now = time.time()
                steps_s = (step_idx + 1 - window_step) / max(now - window_t0,
                                                             1e-9)
                ex_s = steps_s * len(batch["label"])
                log.info("step %d loss %.5f  %.1f steps/s  %.0f ex/s",
                         step_idx + 1, losses[-1], steps_s, ex_s)
                window_t0, window_step = now, step_idx + 1

            do_ckpt = (step_idx + 1) % cfg.save_checkpoints_steps == 0
            if (step_idx + 1) % cfg.eval_every_steps == 0 or \
                    step_idx + 1 == num_steps:
                metrics = evaluate(model, ts.params, ts.model_state,
                                   eval_batches_fn(), device=device,
                                   max_steps=cfg.eval_steps)
                log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f",
                         step_idx + 1, metrics["auc"], metrics["logloss"],
                         metrics["accuracy"])
                do_ckpt = True
            if do_ckpt:
                ckpt.save(step_idx + 1, convert.export_params(
                    (ts.params, ts.model_state, ts.opt_state)),
                    metric=metrics.get("auc"))
    finally:
        batches.close()
    metrics["train_seconds"] = time.time() - t0
    metrics["first_loss"] = losses[0] if losses else float("nan")
    metrics["final_loss"] = losses[-1] if losses else float("nan")
    metrics["examples_per_sec"] = ex_s
    return metrics


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
        ts, loss = step_fn(ts, staged_train, k, done)
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
