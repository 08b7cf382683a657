"""Fast training path: a device-resident dataset and K steps per host call
(counterpart of ``recsys_tpu/train/fast.py``).

- The (preprocessed, fixed-shape) dataset lives on the device as one tensor
  per feature; a step's batch is a device-side row gather, so the steady
  state moves nothing from the host.
- K optimizer steps run per host call. The JAX package fuses them into one
  XLA program with ``lax.scan``; here a Python loop enqueues them, and
  nothing in the loop waits for the device: the step counter, the Adam bias
  correction, the batch indices and the loss all stay on the device, and
  the caller reads the mean loss once per call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from recsys_tpu_torch.models.api import Model
from recsys_tpu_torch.train import train_state as TS


def stage_dataset(data: dict[str, np.ndarray], device) -> dict:
    """Host arrays (a dataset or one batch) → tensors on ``device``; integer
    features (the Criteo ``ids``, DIN's item and category ids) become
    int64, the gathers' index type."""
    out = {}
    for k, v in data.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.to(torch.int64) if not (t.is_floating_point()
                                             or t.dtype == torch.bool)
                  else t).to(device)
    return out


def _take(data: dict, idx: torch.Tensor) -> dict:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def make_scanned_train_step(model: Model, tx):
    """``steps(ts, data, idx [K, B]) -> (ts, mean_loss)``: K optimizer steps
    on host-given batch indices (deterministic; the parity tests use it).
    ``idx`` may be a numpy array or a tensor."""
    step = TS.make_train_step(model, tx)

    def steps(ts, data, idx_matrix):
        first = next(iter(data.values()))
        idx = torch.as_tensor(idx_matrix, dtype=torch.int64,
                              device=first.device)
        total = torch.zeros((), dtype=torch.float32, device=first.device)
        for i in range(idx.shape[0]):
            ts, loss = step(ts, _take(data, idx[i]))
            total = total + loss
        return ts, total / idx.shape[0]

    return steps


def make_scanned_train_step_devgen(model: Model, tx, n_rows: int,
                                   batch_size: int):
    """``steps(ts, data, k, first_step) -> (ts, mean_loss)``: K optimizer
    steps with batch indices drawn on the device, with replacement, from the
    train state's generator — no host-to-device traffic and no host read
    inside the call; the mean loss comes back as a device scalar.
    ``first_step`` is the host's count of the steps ``ts`` has taken: step
    ``first_step + i`` reseeds the generator from (``ts.seed``, that step)
    before it draws its indices and dropout masks (`TS.reseed`), as the
    reference folds the step into its key."""
    step = TS.make_train_step(model, tx)

    def steps(ts, data, k: int, first_step: int):
        device = next(iter(data.values())).device
        total = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(k):
            TS.reseed(ts, first_step + i)
            idx = torch.randint(0, n_rows, (batch_size,), generator=ts.rng,
                                device=device)
            ts, loss = step(ts, _take(data, idx))
            total = total + loss
        return ts, total / k

    return steps


def make_scanned_eval(model: Model):
    """``eval_steps(params, model_state, data, idx [K, B], metric_state)
    -> metric_state``: the streaming metrics over K batches."""
    eval_step = TS.make_eval_step(model)

    def eval_steps(params, model_state, data, idx_matrix, metric_state):
        first = next(iter(data.values()))
        idx = torch.as_tensor(idx_matrix, dtype=torch.int64,
                              device=first.device)
        for i in range(idx.shape[0]):
            metric_state = eval_step(params, model_state, metric_state,
                                     _take(data, idx[i]))
        return metric_state

    return eval_steps


def train_on_device(model: Model, tx, ts, data: dict[str, np.ndarray], *,
                    batch_size: int, num_steps: int, steps_per_call: int = 50,
                    log_every_calls: int = 5, log_fn=None):
    """Drive ``num_steps`` on the fast path (device-drawn batch indices, as
    `loop.train_and_evaluate_fast` runs it) on the device of ``ts``.
    ``log_fn(steps_done, loss, examples_per_sec)`` is called every
    ``log_every_calls`` calls. Returns (ts, last mean loss)."""
    staged = stage_dataset(data, ts.step.device)
    n = len(next(iter(data.values())))
    step_fn = make_scanned_train_step_devgen(model, tx, n, batch_size)
    first = int(ts.step)
    done, calls, loss = 0, 0, float("nan")
    t0 = time.perf_counter()
    while done < num_steps:
        k = min(steps_per_call, num_steps - done)
        ts, mean_loss = step_fn(ts, staged, k, first + done)
        done += k
        calls += 1
        loss = float(mean_loss)   # the one host read of the call
        if log_fn is not None and calls % log_every_calls == 0:
            log_fn(done, loss, done * batch_size / (time.perf_counter() - t0))
    return ts, loss
