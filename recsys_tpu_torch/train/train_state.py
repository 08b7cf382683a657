"""Train state and step factories (counterpart of
``recsys_tpu/train/train_state.py``).

One train step is the model's forward in train mode, the mean sigmoid
cross-entropy, ``torch.autograd.grad`` over every parameter (the embedding
tables' gradients come from `table.table_gather`'s backward, the segment-sum
kernel on the card), and the in-place update of the optimizer the model
declares (`optim.for_model`: TF-parity Adam, FTRL for the wide model,
row-wise Adagrad for DLRM). A table the model names in
``meta['sparse_tables']`` is read as a `table.SparseTable`: its gradient is
the touched rows' (`segment_sum.SparseRows`), never a dense one of the
table's size. Parameters are plain tensors that do not require grad between
steps: each step differentiates through detached aliases of them, so eval
and serving never build a graph. Captured into a CUDA graph, the step
launches the marks ``forward``, ``backward``, ``optimizer`` and ``end`` at
its section boundaries (`profiling.mark`; the K-step calls of `fast`
launch ``begin``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.models.api import Model
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.utils import profiling


class TrainState(NamedTuple):
    params: Any
    model_state: Any          # BN moving stats
    opt_state: Any
    step: torch.Tensor        # int32 scalar on the training device
    rng: torch.Generator      # dropout and batch-index draws, on that device
    seed: int = 0             # the run's root seed (see `reseed`)


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device``: on the card it draws there, so dropout
    masks and batch indices never cross from the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s draws in a run seeded with ``seed``: a
    splitmix64 mix of the pair, the counterpart of the reference's
    ``fold_in(root_key, step)`` (``recsys_tpu/core/prng.py``)."""
    z = (seed * 0x9E3779B97F4A7C15 + step) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def reseed(ts: "TrainState", step: int) -> None:
    """Seed ``ts.rng`` for step ``step`` (the host's count of steps taken),
    so that the step's batch indices and dropout masks depend on (seed,
    step) only and a resumed run draws what the uninterrupted run drew.
    ``manual_seed`` sets the generator's seed and offset on the host. A
    CUDA graph that registered the generator copies them to the card at
    each replay, with two fills outside the graph (`step_graph`)."""
    ts.rng.manual_seed(step_seed(ts.seed, step))


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean sigmoid cross-entropy
    (``tf.nn.sigmoid_cross_entropy_with_logits`` parity)."""
    return M.sigmoid_ce_per_example(logits, labels.to(torch.float32)).mean()


def create_train_state(model: Model, seed: int, learning_rate: float,
                       device="cuda",
                       opt: optim.Optimizer | None = None):
    """(TrainState, optimizer): parameters drawn from a CPU generator seeded
    with ``seed`` (the same values on any device), then moved to
    ``device``; the state's generator lives on ``device`` and the training
    loops reseed it from (``seed``, step) before every step. The device is
    the card unless the caller asks for the CPU: ``cuda`` without a card
    raises, it never falls back. The optimizer is ``opt``, or the one the
    model declares (`optim.for_model`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_train_state(device='cuda'): no CUDA "
                           "device is available")
    params, model_state = model.init(torch.Generator().manual_seed(seed),
                                     device)
    tx = opt if opt is not None else optim.for_model(model.meta,
                                                     learning_rate)
    return TrainState(params, model_state, tx.init(params),
                      torch.zeros((), dtype=torch.int32, device=device),
                      make_generator(seed + 1, device), seed), tx


def loss_and_grads(model: Model, params, model_state, batch,
                   gen: torch.Generator | None = None):
    """(loss, new model state, gradient tree) of the train-mode loss, the
    gradients shaped like ``params`` (zeros for unused leaves, as
    ``jax.grad`` gives). Differentiates through detached aliases, so
    ``params`` need not (and should not) require grad. The top-level
    leaves of ``params`` named in ``model.meta['sparse_tables']`` are read
    as `table.SparseTable` objects, and their gradients are
    `segment_sum.SparseRows`."""
    sparse = tuple(model.meta.get("sparse_tables", ()))
    tables = {k: emb_table.SparseTable(params[k]) for k in sparse}
    dense = ({k: v for k, v in params.items() if k not in tables}
             if tables else params)
    live = [p.detach().requires_grad_() for p in tree_util.leaves(dense)]
    profiling.mark("forward", live[0])
    view = tree_util.fill_like(dense, live)
    logits, new_ms = model.apply({**view, **tables} if tables else view,
                                 model_state, batch, train=True, gen=gen)
    loss = sigmoid_ce(logits, batch["label"])
    profiling.mark("backward", loss)
    grads = torch.autograd.grad(
        loss, live + [t.token for t in tables.values()], allow_unused=True,
        materialize_grads=True)
    grad_tree = tree_util.fill_like(dense, grads[:len(live)])
    for k, t in tables.items():
        if t.grad is None:
            raise RuntimeError(f"loss_and_grads: the sparse table {k!r} "
                               "was not read by a bag")
        grad_tree[k] = t.grad
    return (loss.detach(), tree_util.tree_map(torch.Tensor.detach, new_ms),
            grad_tree)


def make_train_step(model: Model, tx: optim.Optimizer):
    """``step(ts, batch) -> (ts, loss)``. The parameters and the optimizer
    state of ``ts`` are updated in place; the loss stays on the device.
    The host-fed loop (`loop.train_and_evaluate`) steps with it; the K-step
    calls of `fast` use `make_inplace_train_step`."""

    def step(ts: TrainState, batch):
        loss, new_ms, grads = loss_and_grads(model, ts.params,
                                             ts.model_state, batch, ts.rng)
        tx.update(grads, ts.opt_state, ts.params)
        return ts._replace(model_state=new_ms, step=ts.step + 1), loss

    return step


def make_inplace_train_step(model: Model, tx: optim.Optimizer):
    """``body(ts, batch, loss_sum)``: the step of `make_train_step` with
    every change written into storage that outlives it, so that a CUDA
    graph can capture the step once and replay it at the same addresses
    (`fast`): the parameters and the optimizer state are updated in place
    by ``tx``, the BN moving stats are copied into ``ts.model_state``'s
    leaves, and the loss is added into the device scalar ``loss_sum``.
    ``ts.step`` is left to the caller, which advances it once per call."""

    def body(ts: TrainState, batch, loss_sum: torch.Tensor) -> None:
        loss, new_ms, grads = loss_and_grads(model, ts.params,
                                             ts.model_state, batch, ts.rng)
        profiling.mark("optimizer", loss_sum)
        tx.update(grads, ts.opt_state, ts.params)
        with torch.no_grad():
            for dst, src in zip(tree_util.leaves(ts.model_state),
                                tree_util.leaves(new_ms), strict=True):
                dst.copy_(src)
            loss_sum.add_(loss)
        profiling.mark("end", loss_sum)

    return body


def make_eval_step(model: Model):
    """``eval_step(params, model_state, metric_state, batch) ->
    metric_state``: the eval-mode forward and the streaming-metric update,
    on the device."""

    @torch.no_grad()
    def eval_step(params, model_state, metric_state, batch):
        logits, _ = model.apply(params, model_state, batch, train=False)
        return M.update_binary_metrics(metric_state, logits, batch["label"])

    return eval_step


def make_predict_step(model: Model):
    """``predict(params, model_state, batch) -> probs`` [B] — the serving
    signature: sigmoid of the eval-mode logits."""

    def predict(params, model_state, batch):
        logits, _ = model.apply(params, model_state, batch, train=False)
        return torch.sigmoid(logits)

    return predict
