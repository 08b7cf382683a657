"""Fast training path: a device-resident dataset and K steps per host call
(counterpart of ``recsys_tpu/train/fast.py``).

- The (preprocessed, fixed-shape) dataset lives on the device as one tensor
  per feature; a step's batch is a device-side row gather, so the steady
  state moves nothing from the host.
- K optimizer steps run per host call. The JAX package fuses them into one
  XLA program with ``lax.scan``. Here, on CUDA, one step is captured as a
  CUDA graph (`step_graph`) and replayed K times: per step the host
  reseeds the generator (devgen) or copies the step's row of host-given
  indices, then launches the graph once. The step body writes all it
  changes in place (`train_state.make_inplace_train_step`), so nothing in
  the call waits for the device: the step counter, the Adam bias
  correction, the batch indices and the loss stay on the device, and the
  caller reads the mean loss once per call.
- ``graphed=False`` runs the same body eagerly, one kernel at a time from
  Python: on the CPU, where there are no graphs, and on the card as the
  plain version the graphed path is held against.
- The sampler call (`make_scanned_train_step_sampler`) needs no dataset:
  each step draws a fresh batch of the planted task on the device inside
  the captured step (``tools/converge.py``).
- Tracing (`profiling`): a training call is the host span
  ``recsys.train.call``, the host's part of each step
  ``recsys.train.host_step`` inside it; each captured training step
  launches the mark ``begin`` first (then ``forward``, ``backward``,
  ``optimizer`` and ``end`` from `train_state`), so a device trace splits
  every replay into its sections. The eval call records neither.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from recsys_tpu_torch.models.api import Model
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import step_graph
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling


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


def _device(data: dict) -> torch.device:
    return next(iter(data.values())).device


def _loop(graph: step_graph.StepGraph, graphed: bool | None, device, k: int,
          held, new_static, host, step, generators=()):
    """K steps of ``step(static)``; → the static tensors after them.

    ``new_static()`` makes the tensors the step reads and writes besides
    ``held`` (the train state, the data and the static tensors' shapes:
    the graph's key); ``host(i, static)`` does the host's part of step
    ``i`` (at step 0 also the call's own: zero the loss sum, copy a metric
    state in; then reseed or copy indices or a batch).
    Graphed, the first step after a capture is its warm-up and the rest
    replay the graph; eagerly (or for no step at all), each step runs
    from Python."""
    if not step_graph.use_graph(graphed, device, graph.name) or k == 0:
        static = new_static()
        for i in range(k):
            host(i, static)
            step(static)
        return static
    static, start = graph.static_for(held), 0
    if static is None:
        static, start = new_static(), 1
        host(0, static)
        graph.capture(held, static, lambda: step(static), generators)
    for i in range(start, k):
        host(i, static)
        graph.replay()
    return static


def _run(graph: step_graph.StepGraph, graphed: bool | None, device, k: int,
         held, new_static, host, step, generators=()):
    """`_loop` for a training call: the call is the host span
    ``recsys.train.call``, each ``host`` in it ``recsys.train.host_step``."""
    def host_step(i, static):
        with profiling.span("recsys.train.host_step"):
            host(i, static)

    with profiling.span("recsys.train.call"):
        return _loop(graph, graphed, device, k, held, new_static, host_step,
                     step, generators)


def _train_static(batch_size: int, device):
    """(index buffer, loss sum) of a train step."""
    return (torch.empty((batch_size,), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.float32, device=device))


def make_scanned_train_step(model: Model, tx, *, graphed: bool | None = None):
    """``steps(ts, data, idx [K, B]) -> (ts, mean_loss)``: K optimizer steps
    on host-given batch indices (deterministic; the parity tests use it).
    ``idx`` may be a numpy array or a tensor. ``graphed`` (default: on
    CUDA) replays one captured step per step; True off CUDA raises."""
    body = TS.make_inplace_train_step(model, tx)
    graph = step_graph.StepGraph("make_scanned_train_step")

    def steps(ts, data, idx_matrix):
        device = _device(data)
        idx = torch.as_tensor(idx_matrix, dtype=torch.int64, device=device)
        k, b = idx.shape

        def host(i, static):
            if i == 0:
                static[1].zero_()
            static[0].copy_(idx[i])

        def step(static):
            profiling.mark("begin", static[0])
            body(ts, _take(data, static[0]), static[1])

        # the key holds the index buffer's width: a new width captures anew
        static = _run(graph, graphed, device, k,
                      (ts.params, ts.model_state, ts.opt_state, ts.rng, data,
                       b),
                      lambda: _train_static(b, device), host, step, (ts.rng,))
        return ts._replace(step=ts.step + k), static[1] / k

    return steps


def make_scanned_train_step_devgen(model: Model, tx, n_rows: int,
                                   batch_size: int, *,
                                   graphed: bool | None = None):
    """``steps(ts, data, k, first_step) -> (ts, mean_loss)``: K optimizer
    steps with batch indices drawn on the device, with replacement, from the
    train state's generator — no host-to-device traffic and no host read
    inside the call; the mean loss comes back as a device scalar.
    ``first_step`` is the host's count of the steps ``ts`` has taken: step
    ``first_step + i`` reseeds the generator from (``ts.seed``, that step)
    before it draws its indices and dropout masks (`TS.reseed`), as the
    reference folds the step into its key. ``graphed`` (default: on CUDA)
    replays one captured step per step; True off CUDA raises."""
    body = TS.make_inplace_train_step(model, tx)
    graph = step_graph.StepGraph("make_scanned_train_step_devgen")

    def steps(ts, data, k: int, first_step: int):
        device = _device(data)

        def host(i, static):
            if i == 0:
                static[1].zero_()
            TS.reseed(ts, first_step + i)

        def step(static):
            idx, loss_sum = static
            profiling.mark("begin", idx)
            idx.random_(0, n_rows, generator=ts.rng)   # = torch.randint
            body(ts, _take(data, idx), loss_sum)

        static = _run(graph, graphed, device, k,
                      (ts.params, ts.model_state, ts.opt_state, ts.rng, data),
                      lambda: _train_static(batch_size, device), host, step,
                      (ts.rng,))
        return ts._replace(step=ts.step + k), static[1] / k

    return steps


def make_scanned_train_step_sampler(model: Model, tx, sample_fn,
                                    batch_size: int, *,
                                    graphed: bool | None = None):
    """``steps(ts, tables, k, first_step) -> (ts, mean_loss)``: K optimizer
    steps, each on a FRESH batch that ``sample_fn(gen, tables,
    batch_size)`` draws on the device (`synthetic_device.make_device_sampler`):
    one-pass online training on the population, with no dataset on the
    card and nothing from the host. Step ``first_step + i`` reseeds
    ``ts.rng`` from (``ts.seed``, that step) (`TS.reseed`), then draws its
    batch and then its dropout masks from it, in that order; so a resumed
    run draws what the uninterrupted run drew. ``graphed`` (default: on
    CUDA) replays one captured step, the sampler's draws inside it, per
    step; the graph is keyed by ``tables`` too, so other tables capture
    anew. True off CUDA raises."""
    body = TS.make_inplace_train_step(model, tx)
    graph = step_graph.StepGraph("make_scanned_train_step_sampler")

    def steps(ts, tables: dict, k: int, first_step: int):
        device = _device(tables)

        def host(i, static):
            if i == 0:
                static[0].zero_()
            TS.reseed(ts, first_step + i)

        def step(static):
            profiling.mark("begin", static[0])
            body(ts, sample_fn(ts.rng, tables, batch_size), static[0])

        static = _run(graph, graphed, device, k,
                      (ts.params, ts.model_state, ts.opt_state, ts.rng,
                       tables, batch_size),
                      lambda: (torch.zeros((), dtype=torch.float32,
                                           device=device),),
                      host, step, (ts.rng,))
        return ts._replace(step=ts.step + k), static[0] / k

    return steps


def make_fed_train_step(model: Model, tx, *, graphed: bool | None = None):
    """``step(ts, batch, step_idx) -> loss``: one optimizer step on a batch
    already on the device (`loader.device_prefetch`'s), the host-fed
    loop's step (`loop.train_and_evaluate`). ``step_idx`` is the host's
    count of the steps ``ts`` has taken; the step reseeds the generator
    from (``ts.seed``, ``step_idx``) before it draws its dropout masks.
    ``ts.step`` is left to the caller. → the step's loss, a new device
    scalar.

    Graphed (by default on CUDA; True off CUDA raises), the step is
    captured once per train state and batch layout and replayed: the host
    copies the batch, device to device on the current stream, into the
    graph's static batch buffers, reseeds, and launches the graph, which
    zeroes its static loss first. Only that copy is ordered before the
    replay, so nothing writes a buffer a running replay reads, while the
    prefetcher's copy of the next batch overlaps it. The key holds every
    leaf, the generator and each batch tensor's shape and type, so a new
    history length P or a short batch captures anew. ``graphed=False`` runs
    the same body eagerly, from Python."""
    body = TS.make_inplace_train_step(model, tx)
    graph = step_graph.StepGraph("make_fed_train_step")

    def step(ts, batch: dict, step_idx: int) -> torch.Tensor:
        device = _device(batch)
        layout = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}

        def new_static():
            """(loss, batch buffers)."""
            return (torch.zeros((), dtype=torch.float32, device=device),
                    {k: torch.empty_like(v) for k, v in batch.items()})

        def host(i, static):
            for k, v in batch.items():
                static[1][k].copy_(v)
            TS.reseed(ts, step_idx)

        def run(static):
            profiling.mark("begin", static[0])
            static[0].zero_()
            body(ts, static[1], static[0])

        static = _run(graph, graphed, device, 1,
                      (ts.params, ts.model_state, ts.opt_state, ts.rng,
                       layout),
                      new_static, host, run, (ts.rng,))
        return static[0].clone()

    return step


def make_scanned_eval(model: Model, *, graphed: bool | None = None):
    """``eval_steps(params, model_state, data, idx [K, B], metric_state)
    -> metric_state``: the streaming metrics over K batches. The step
    updates a static metric state in place; the caller's state is copied
    in once a call, and the result comes back as new tensors. ``graphed``
    as for the train steps."""
    eval_step = TS.make_eval_step(model)
    graph = step_graph.StepGraph("make_scanned_eval")

    def eval_steps(params, model_state, data, idx_matrix, metric_state):
        device = _device(data)
        idx = torch.as_tensor(idx_matrix, dtype=torch.int64, device=device)
        k, b = idx.shape

        def new_static():
            return (torch.empty((b,), dtype=torch.int64, device=device),
                    M.BinaryMetricState(*(torch.empty_like(t)
                                          for t in metric_state)))

        def host(i, static):
            if i == 0:
                for dst, src in zip(static[1], metric_state, strict=True):
                    dst.copy_(src)
            static[0].copy_(idx[i])

        def step(static):
            state = static[1]
            new = eval_step(params, model_state, state,
                            _take(data, static[0]))
            for dst, src in zip(state, new):
                dst.copy_(src)

        static = _loop(graph, graphed, device, k,
                       (params, model_state, data, b,
                        [tuple(t.shape) for t in metric_state]),
                       new_static, host, step)
        return M.BinaryMetricState(*(t.clone() for t in static[1]))

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
