"""SPMD training over the ``('data', 'model')`` mesh (counterpart of
``recsys_tpu/parallel/spmd.py``): one process per device, every rank
running the same step on its slice of the state and of the batch.

- The batch is split over ``data``: rank (d, m) takes rows
  ``[d·B/D, (d+1)·B/D)`` of the global batch.
- The packed embedding tables (``param_specs``: the fused engine's
  ``table_flat``, the split engine's ``big`` and the wide model's ``w``)
  are split by rows over ``model``; every other leaf is whole on every
  rank. Unlike the JAX package, whose
  split engine keeps its big table transposed, every split leaf of the port
  splits dim 0.
- The step differentiates the loss over the global batch (a sum over the
  rank's rows divided by the global batch size), sums the gradients over
  ``data`` (one all-reduce of all of them, the loss and the BN stats),
  rescales the split leaves' gradients (`normalize_model_replication`),
  averages the BN stats over ``data`` and updates in place.

The state is the local path's `train_state.TrainState`, its split leaves
holding this rank's rows (`create_spmd_state` builds the whole tree from
the seed as the local path does, then slices it); the models run the same
bodies as on one device, with `api.EmbOps` routing their table reads
through the exchange (``parallel/sharded_embedding.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.mesh import MeshEnv
from recsys_tpu_torch.models.api import LOCAL_EMB_OPS, EmbOps, Model
from recsys_tpu_torch.parallel import collectives as C
from recsys_tpu_torch.parallel import sharded_embedding as SE
from recsys_tpu_torch.parallel.collectives import Axis
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train import train_state as TS

#: a leaf's spec: dim 0 split over the model axis (None: whole everywhere)
ROWS = "model"
#: leaves split by rows whatever subtree holds them
_ROW_LEAVES = {"table_flat", "big"}


def sharded_emb_ops(axis: Axis, exact: bool = False,
                    cap_factor: float = 2.0) -> EmbOps:
    """EmbOps whose table reads exchange rows over ``axis``: the engines'
    dedup + all-to-all lookup and the sharded wide sum."""
    return EmbOps(
        linear=lambda p, gids: SE.sharded_linear_sum(p["w"], p["b"], gids,
                                                     axis),
        sharded=True, a2a_exact=exact, a2a_cap_factor=cap_factor, axis=axis)


def make_sharded_emb_ops(env: MeshEnv, exact: bool = False,
                         cap_factor: float = 2.0) -> EmbOps:
    """The ops of the SPMD step on ``env``. A model axis of one member
    gives the local ops, as in the JAX package: the member owns the whole
    table, and the exchange would be pure overhead."""
    if env.num_model == 1:
        return LOCAL_EMB_OPS
    return sharded_emb_ops(env.model, exact, cap_factor)


def param_specs(params):
    """The spec tree of ``params``: `ROWS` for the packed tables, None for
    every other leaf."""

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return tree_util.seq_like(node, (walk(v, keys) for v in node))
        last = keys[-1] if keys else None
        if last in _ROW_LEAVES or (last == "w" and "wide" in keys):
            return ROWS
        return None

    return walk(params, ())


def opt_specs(pspecs, opt_state):
    """The spec tree of an optimizer state: per-parameter accumulators
    (Adam's mu/nu, FTRL's z/n) take their parameter's spec, the step count
    is whole."""
    if isinstance(opt_state, optim.AdamState):
        return optim.AdamState(count=None, mu=pspecs, nu=pspecs)
    if isinstance(opt_state, optim.FtrlState):
        return optim.FtrlState(z=pspecs, n=pspecs)
    raise TypeError(f"unknown optimizer state {type(opt_state)}")


def state_specs(ts: TS.TrainState):
    """Specs of (params, model_state, opt_state)."""
    pspecs = param_specs(ts.params)
    return (pspecs, tree_util.tree_map(lambda _: None, ts.model_state),
            opt_specs(pspecs, ts.opt_state))


def normalize_model_replication(grads, pspecs, num_model: int):
    """Divide the split leaves' gradients by the model axis' size, in place.

    Every member of a model group computes the same loss, so the lookup's
    collectives carry E identical cotangents back to the table: the split
    leaves' gradients come out E× too large, while the whole leaves (whose
    loss never crosses a collective) stay 1×. Adam's scale invariance
    would hide this; FTRL would not."""
    for g, s in zip(tree_util.leaves(grads), tree_util.leaves(pspecs),
                    strict=True):
        if s == ROWS:
            g.div_(num_model)
    return grads


def shard_tree(tree, specs, env: MeshEnv):
    """This rank's slice of a whole tree, on ``env.device``: its rows of
    the split leaves, a copy of the others."""

    def piece(leaf, spec):
        if spec == ROWS:
            rows = SE.shard_rows_of(leaf.shape[0], env.num_model)
            leaf = leaf[env.m * rows:(env.m + 1) * rows]
        return leaf.to(env.device, copy=True)

    return tree_util.tree_map(piece, tree, specs)


#: bytes of a split leaf that each member sends rank 0 at a time when a tree
#: is gathered to its host: a card holds at most one such piece per member,
#: never a whole split leaf
GATHER_PIECE_BYTES = 64 << 20


def gather_to_host(tree, specs, env: MeshEnv):
    """Rank 0: the whole tree as CPU tensors; every other rank: None.

    A collective of the ranks of d = 0 (the model group that holds rank 0;
    the others return at once). A whole leaf is rank 0's own copy; a split
    leaf comes over row piece by row piece (`GATHER_PIECE_BYTES` a member),
    each piece copied into the host tree before the next is sent."""
    if env.d != 0:
        return None
    root = env.rank == 0

    def piece(leaf, spec):
        if spec != ROWS:
            return leaf.cpu() if root else None
        rows = leaf.shape[0]
        whole = (torch.empty((rows * env.num_model, *leaf.shape[1:]),
                             dtype=leaf.dtype) if root else None)
        row_bytes = max(1, leaf.numel() // max(1, rows)) * leaf.element_size()
        step = max(1, GATHER_PIECE_BYTES // row_bytes)
        for start in range(0, rows, step):
            part = leaf[start:start + step].contiguous()
            got = ([torch.empty_like(part) for _ in range(env.num_model)]
                   if root else None)
            dist.gather(part, got, dst=0, group=env.model.group)
            for j, g in enumerate(got or ()):
                whole[j * rows + start:j * rows + start + len(part)].copy_(g)
        return whole

    with torch.no_grad():
        out = tree_util.tree_map(piece, tree, specs)
    return out if root else None


def create_spmd_state(model: Model, env: MeshEnv, seed: int,
                      opt: optim.Optimizer) -> TS.TrainState:
    """This rank's slice of the state the local path makes from ``seed``
    (made whole on the host, then sliced; the generator on
    ``env.device``, seeded as the local path seeds its own)."""
    ts, _ = TS.create_train_state(model, seed, 0.0, "cpu", opt)
    pspecs, mspecs, ospecs = state_specs(ts)
    return TS.TrainState(
        params=shard_tree(ts.params, pspecs, env),
        model_state=shard_tree(ts.model_state, mspecs, env),
        opt_state=shard_tree(ts.opt_state, ospecs, env),
        step=ts.step.to(env.device, copy=True),
        rng=TS.make_generator(seed + 1, env.device), seed=seed)


def local_rows(batch: dict, env: MeshEnv, axis: int = 0) -> dict:
    """This rank's rows of a global batch (dim ``axis`` split over
    ``data``)."""
    n = next(iter(batch.values())).shape[axis]
    if n % env.num_data:
        raise ValueError(f"batch of {n} rows not divisible by data axis "
                         f"{env.num_data}")
    size = n // env.num_data
    sl = (slice(None),) * axis + (slice(env.d * size, (env.d + 1) * size),)
    return {k: v[sl] for k, v in batch.items()}


def loss_and_grads(model: Model, ts: TS.TrainState, batch: dict,
                   step_idx: int, env: MeshEnv, emb_ops: EmbOps,
                   global_batch_size: int):
    """(loss, new model state, gradient tree) of the SPMD step on this
    rank's rows of the global batch: the loss of the global batch, the BN
    stats averaged over ``data``, the gradients summed over ``data`` and
    rescaled by `normalize_model_replication` (what the optimizer takes).
    Dropout draws from (``ts.seed``, ``step_idx``, d)."""
    ts.rng.manual_seed(TS.step_seed(TS.step_seed(ts.seed, step_idx), env.d))
    live = [p.detach().requires_grad_() for p in tree_util.leaves(ts.params)]
    logits, new_ms = model.apply(tree_util.fill_like(ts.params, live),
                                 ts.model_state, batch, train=True,
                                 gen=ts.rng, emb_ops=emb_ops)
    ce = M.sigmoid_ce_per_example(logits,
                                  batch["label"].to(torch.float32)).sum()
    loss = ce / global_batch_size
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    ms = [t.detach() for t in tree_util.leaves(new_ms)]
    # one all-reduce over data: the gradients, the loss and the BN stats
    parts = list(grads) + [loss.detach()] + ms
    flat = torch.cat([t.reshape(-1) for t in parts])
    C.all_reduce_(flat, env.data)
    summed = [piece.view_as(t) for piece, t in
              zip(flat.split([t.numel() for t in parts]), parts)]
    n = len(grads)
    grad_tree = normalize_model_replication(
        tree_util.fill_like(ts.params, summed[:n]), param_specs(ts.params),
        emb_ops.axis.size if emb_ops.sharded else 1)
    new_ms = tree_util.fill_like(new_ms,
                                 [t / env.num_data for t in summed[n + 1:]])
    return summed[n], new_ms, grad_tree


def make_spmd_train_step(model: Model, opt: optim.Optimizer, env: MeshEnv,
                         global_batch_size: int, a2a_exact: bool = False,
                         a2a_cap_factor: float = 2.0,
                         emb_ops: EmbOps | None = None):
    """``step(ts, batch, step_idx) -> (ts, loss)`` on this rank's rows of
    the global batch (`loss_and_grads`, then the optimizer). The
    parameters and optimizer state of ``ts`` are updated in place; the loss
    stays on the device. ``emb_ops`` defaults to `make_sharded_emb_ops` of
    ``env``."""
    if emb_ops is None:
        emb_ops = make_sharded_emb_ops(env, a2a_exact, a2a_cap_factor)

    def step(ts: TS.TrainState, batch: dict, step_idx: int):
        loss, new_ms, grads = loss_and_grads(model, ts, batch, step_idx, env,
                                             emb_ops, global_batch_size)
        opt.update(grads, ts.opt_state, ts.params)
        return ts._replace(model_state=new_ms, step=ts.step + 1), loss

    return step


def make_spmd_train_step_scanned(model: Model, opt: optim.Optimizer,
                                 env: MeshEnv, global_batch_size: int,
                                 a2a_exact: bool = False,
                                 a2a_cap_factor: float = 2.0):
    """``steps(ts, stack, first_step) -> (ts, mean loss)``: one step of
    `make_spmd_train_step` for each of the K batches of ``stack``
    (tensors [K, B/D, ...], this rank's rows), steps ``first_step`` … +K−1.
    The JAX package fuses the K steps into one program; here they run
    eagerly, their collectives issued from the host."""
    step = make_spmd_train_step(model, opt, env, global_batch_size,
                                a2a_exact, a2a_cap_factor)

    def steps(ts: TS.TrainState, stack: dict, first_step: int):
        k = next(iter(stack.values())).shape[0]
        total = None
        for i in range(k):
            ts, loss = step(ts, {key: v[i] for key, v in stack.items()},
                            first_step + i)
            total = loss if total is None else total + loss
        return ts, total / k

    return steps


def make_spmd_eval_logits(model: Model, env: MeshEnv,
                          a2a_exact: bool = False,
                          a2a_cap_factor: float = 2.0):
    """``logits(params, model_state, batch) -> [B]``: the eval forward on
    this rank's rows, gathered over ``data`` into the global batch's
    logits (the same on every rank)."""
    emb_ops = make_sharded_emb_ops(env, a2a_exact, a2a_cap_factor)

    @torch.no_grad()
    def logits(params, model_state, batch):
        out, _ = model.apply(params, model_state, batch, train=False,
                             emb_ops=emb_ops)
        return C.all_gather(out, env.data)

    return logits
