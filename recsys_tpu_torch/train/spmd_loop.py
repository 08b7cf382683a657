"""Multi-device training drivers (counterpart of
``recsys_tpu/train/spmd_loop.py``): the batch split over the mesh's
``data`` axis, the embedding tables over ``model`` (the dedup + all-to-all
lookup), K eager SPMD steps per call (``parallel/spmd.py``), and eval,
scalars and checkpoints as in the single-device loops, resume included.

- `train_and_evaluate_spmd_stream`: host batch streams (``ShardSource``)
  grouped into K-batch stacks and moved to the device by
  ``loader.device_prefetch``.
- `train_and_evaluate_spmd`: the same driver over a dataset held in host
  memory; every rank draws the same global batch indices from the seed
  and takes its rows.

Every rank runs the same program. The loss, the eval metrics and the
decisions (capacity check, end of a stream, an input error) are the same
on every rank: the metrics are updated with the global batch's logits and
labels, and every stream step is agreed over the world before anyone
enters a collective, so one rank's end of stream or error stops every rank
instead of leaving the others waiting. Checkpoints hold the whole tree in
the JAX package's format (the same files a single-device run writes): the
split leaves are gathered to rank 0's host memory piece by piece, and
rank 0 writes them, with ``best/`` and the scalars; on resume each rank
reads the checkpoint leaf by leaf and keeps its rows.

Reachable from the command line: ``torchrun --nproc_per_node=N -m
recsys_tpu_torch.tools.train_ctr train --mesh.model_axis=M ...`` takes the
stream driver whenever the world has more than one rank.
"""

from __future__ import annotations

import itertools
import logging
import time

import numpy as np
import torch
import torch.distributed as dist

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import MeshConfig, TrainConfig
from recsys_tpu_torch.core.mesh import MeshEnv, make_mesh
from recsys_tpu_torch.data.loader import device_prefetch
from recsys_tpu_torch.models.api import Model
from recsys_tpu_torch.parallel import collectives as C
from recsys_tpu_torch.parallel import spmd
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.train.summaries import ScalarWriter

log = logging.getLogger("recsys_tpu_torch")

#: how a rank's next input stands, in the order the world agrees on (MIN):
#: any failure beats any end, any end beats a skip, a skip beats a use
_FAILED, _ENDED, _SKIP, _USE = 0, 1, 2, 3


def _world_reduce(value: int, env: MeshEnv, op) -> int:
    t = torch.tensor([value], dtype=torch.int64, device=env.device)
    dist.all_reduce(t, op=op)
    return int(t.item())


def _next_agreed(it, env: MeshEnv, usable=None):
    """(status, item): ``next(it)`` on every rank of the world in step.
    The status is the worst over the ranks: ``_USE`` only when every rank
    has a usable item (``usable(item)``, by default any); ``_SKIP`` when
    some rank's item is not usable (every rank drops its item);
    ``_ENDED`` when some rank's iterator has ended; when some rank's
    ``next`` raised, that rank raises its error and the others a
    RuntimeError, so no rank waits on a collective the others never
    enter."""
    item, err, status = None, None, _USE
    try:
        item = next(it)
        if usable is not None and not usable(item):
            status = _SKIP
    except StopIteration:
        status = _ENDED
    except Exception as e:  # noqa: BLE001 - raised below, on every rank
        err, status = e, _FAILED
    agreed = _world_reduce(status, env, dist.ReduceOp.MIN)
    if agreed == _FAILED:
        if err is not None:
            raise err
        raise RuntimeError("the input stream of another rank failed (its "
                           "error is in that rank's log)")
    return agreed, (item if agreed == _USE else None)


def resolve_a2a_exact(model: Model, mesh_cfg: MeshConfig, env: MeshEnv,
                      sample_ids: list[np.ndarray]) -> bool:
    """Startup capacity check for the non-exact a2a embedding exchange.

    The dedup + all-to-all lookup sizes its per-owner capacity by
    ``mesh_cfg.a2a_cap_factor``; unique ids beyond it would read as zero
    rows AND drop their gradients. That must never happen silently: before
    training, the driver measures the overflow that THIS id distribution
    would produce (``engine.a2a_overflow`` over sampled batches, this
    rank's rows of each, worst over the world) and applies
    ``mesh_cfg.a2a_policy``:

    - 'check' (default): overflow > 0 → raise with guidance;
    - 'auto':            overflow > 0 → upgrade the run to exact capacity
                         (lossless, larger collectives) with a warning;
    - 'off':             trust the factor, skip the measurement.

    Returns the effective ``a2a_exact`` flag for the run; every rank calls
    it and gets the same answer."""
    if mesh_cfg.a2a_exact or env.num_model <= 1:
        return mesh_cfg.a2a_exact
    if mesh_cfg.a2a_policy == "off":
        return False
    engine = model.meta.get("engine")
    if engine is None or not hasattr(engine, "a2a_overflow"):
        return False   # the model has no a2a path
    local = max(engine.a2a_overflow(ids, 1, env.num_model,
                                    mesh_cfg.a2a_cap_factor)
                for ids in sample_ids)
    worst = _world_reduce(local, env, dist.ReduceOp.MAX)
    if worst == 0:
        log.info(
            "a2a capacity check: cap_factor=%.2f lossless for %d sampled "
            "batches (mesh %dx%d)", mesh_cfg.a2a_cap_factor,
            len(sample_ids), env.num_data, env.num_model)
        return False
    if mesh_cfg.a2a_policy == "auto":
        log.warning(
            "a2a capacity check: %d unique ids/batch would overflow "
            "cap_factor=%.2f — upgrading this run to a2a_exact=True "
            "(lossless, larger collectives)", worst,
            mesh_cfg.a2a_cap_factor)
        return True
    raise ValueError(
        f"sharded-embedding a2a overflow: {worst} unique ids of a sampled "
        f"batch exceed the per-owner capacity at "
        f"a2a_cap_factor={mesh_cfg.a2a_cap_factor} on a "
        f"{env.num_data}x{env.num_model} mesh — activations and gradients "
        "for those ids would be silently dropped. Fix: raise "
        "--mesh.a2a_cap_factor, set --mesh.a2a_exact=true (lossless), or "
        "set --mesh.a2a_policy=auto to upgrade automatically.")


def whole_state(ts: TS.TrainState, env: MeshEnv):
    """Rank 0: the whole (params, model_state, opt_state) in the JAX
    layout, as numpy; every other rank: None. A collective of the ranks
    of d = 0 (`spmd.gather_to_host`: the split leaves come to rank 0's
    host memory piece by piece)."""
    host = spmd.gather_to_host((ts.params, ts.model_state, ts.opt_state),
                               spmd.state_specs(ts), env)
    return None if host is None else convert.export_params(host)


def resume_state(ts: TS.TrainState, ckpt: checkpoint.CheckpointManager,
                 env: MeshEnv) -> TS.TrainState:
    """``ts`` with this rank's rows of the latest checkpoint copied in.
    The checkpoint is read one leaf at a time on the host, and only this
    rank's rows of a split leaf go to the device."""
    step = ckpt.latest_step()
    if step is None:
        return ts
    state = (ts.params, ts.model_state, ts.opt_state)
    mine = checkpoint.flatten(state)
    specs = tree_util.leaves(spmd.state_specs(ts))
    saved = ckpt.leaves(step)
    with torch.no_grad():
        for (path, dst), spec in zip(mine, specs, strict=True):
            # the port's big table is the JAX package's big_wm, transposed
            jax_path = path.replace("['big']", "['big_wm']")
            got_path, arr = next(saved, (None, None))
            if got_path != jax_path:
                raise ValueError(f"checkpoint leaf {got_path} where the "
                                 f"state has {jax_path}")
            if jax_path != path:
                arr = arr.T
            want = tuple(dst.shape)
            if spec == spmd.ROWS:
                rows = want[0]
                want = (rows * env.num_model, *want[1:])
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint leaf {got_path} "
                                 f"{tuple(arr.shape)} does not match the "
                                 f"state's {want}")
            if spec == spmd.ROWS:
                arr = arr[env.m * rows:(env.m + 1) * rows]
            dst.copy_(torch.from_numpy(arr))
        if next(saved, None) is not None:
            raise ValueError("the checkpoint has more leaves than the state")
    log.info("resumed from step %d", step)
    return ts._replace(step=torch.tensor(step, dtype=torch.int32,
                                         device=env.device))


class _Outputs:
    """Eval log lines, scalars and checkpoints of a run: the gather on
    every rank, the files from rank 0."""

    def __init__(self, cfg: TrainConfig, env: MeshEnv, global_bs: int):
        self.env, self.global_bs = env, global_bs
        self.ckpt = checkpoint.CheckpointManager(cfg.model_dir, cfg.keep_checkpoint_max)
        self.writer = ScalarWriter(cfg.model_dir) if env.rank == 0 else None
        self.t0 = self.window_t0 = time.time()

    def rate(self, steps: int) -> float:
        """Steps/s over the ``steps`` since the last call."""
        now = time.time()
        rate = steps / max(now - self.window_t0, 1e-9)
        self.window_t0 = now
        return rate

    def report(self, ts, done: int, loss_v: float, rate: float,
               metrics: dict, tag: str) -> None:
        env = self.env
        log.info("%s step %d loss %.5f  %.1f steps/s  %.0f ex/s (mesh "
                 "%dx%d)", tag, done, loss_v, rate, rate * self.global_bs,
                 env.num_data, env.num_model)
        log.info("eval @ step %d: auc %.5f logloss %.5f acc %.5f", done,
                 metrics["auc"], metrics["logloss"], metrics["accuracy"])
        whole = whole_state(ts, env)
        if env.rank == 0:
            self.writer.write(done, loss=loss_v,
                              examples_per_sec=rate * self.global_bs,
                              eval_auc=metrics["auc"],
                              eval_logloss=metrics["logloss"])
            self.ckpt.save(done, whole, metric=metrics.get("auc"))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def train_and_evaluate_spmd(
    model: Model,
    train_data: dict[str, np.ndarray],
    eval_data: dict[str, np.ndarray],
    cfg: TrainConfig,
    mesh_cfg: MeshConfig = MeshConfig(),
    *,
    num_steps: int,
    steps_per_call: int = 10,
    env: MeshEnv | None = None,
) -> dict[str, float]:
    """`train_and_evaluate_spmd_stream` over a dataset that every rank
    holds whole in host memory: global batches of ``cfg.batch_size`` rows
    drawn with replacement (every rank draws the same indices from
    ``cfg.seed`` and takes its rows), evaluated over the first
    ``cfg.eval_steps`` global batches of ``eval_data``."""
    env = env if env is not None else make_mesh(mesh_cfg)
    bs = cfg.batch_size
    n_train = len(train_data["label"])

    def train_batches():
        rng = np.random.default_rng(cfg.seed)
        while True:
            idx = rng.integers(0, n_train, size=bs)
            yield spmd.local_rows({k: v[idx] for k, v in train_data.items()},
                                  env)

    def eval_batches():
        for i in range(len(eval_data["label"]) // bs):
            yield spmd.local_rows({k: v[i * bs:(i + 1) * bs]
                                   for k, v in eval_data.items()}, env)

    return train_and_evaluate_spmd_stream(
        model, train_batches(), eval_batches, cfg, mesh_cfg,
        num_steps=num_steps, steps_per_call=steps_per_call, env=env)


def _stack_iter(host_iter, k: int):
    """Group a stream of host batches into [K, B, ...] stacks. A trailing
    partial group (fewer than K batches left in the stream) is dropped."""
    while True:
        group = list(itertools.islice(host_iter, k))
        if len(group) < k:
            if group:
                log.info("dropping trailing partial stack of %d batches",
                         len(group))
            return
        yield {key: np.stack([g[key] for g in group]) for key in group[0]}


def train_and_evaluate_spmd_stream(
    model: Model,
    train_batches,
    eval_batches_fn,
    cfg: TrainConfig,
    mesh_cfg: MeshConfig = MeshConfig(),
    *,
    num_steps: int,
    steps_per_call: int = 10,
    env: MeshEnv | None = None,
) -> dict[str, float]:
    """Streaming multi-device driver: host batches → K-batch stacks →
    ``device_prefetch`` → K eager SPMD steps per call.

    ``train_batches`` and ``eval_batches_fn()`` yield THIS RANK'S batches:
    its rows of the global batch (``spmd.local_rows``), or a stream of its
    own (a per-rank file shard, ``mesh.host_shard_of``); ranks of one data
    shard (one d) must yield the same batches. The global batch is the
    local one times the data axis. The run ends at ``num_steps`` or when
    any rank's stream ends (a trailing partial stack is dropped). Eval
    batches of another size than the train batch are skipped on every rank.

    The startup capacity check looks at the first stack; as a stream can
    drift to a heavier id-to-owner skew later, every 64th stack is checked
    again (host numpy, in the prefetcher's generation thread), and an
    overflow raises in the caller, on every rank. → the last eval's metrics
    plus ``train_seconds``, ``final_loss`` and ``steps_done``."""
    env = env if env is not None else make_mesh(mesh_cfg)
    opt = optim.for_model(model.meta, cfg.learning_rate)
    ts = spmd.create_spmd_state(model, env, cfg.seed, opt)
    stack_iter = _stack_iter(iter(train_batches), steps_per_call)
    status, first = _next_agreed(stack_iter, env)
    if status != _USE:
        raise ValueError("train stream yielded no full stack of "
                         f"{steps_per_call} batches")
    bs = len(first["label"][0])
    global_bs = bs * env.num_data
    a2a_exact = resolve_a2a_exact(
        model, mesh_cfg, env,
        [first["ids"][i] for i in range(min(4, steps_per_call))])
    out = _Outputs(cfg, env, global_bs)
    ts = resume_state(ts, out.ckpt, env)
    done = int(ts.step)
    engine = model.meta.get("engine")
    recheck = (not a2a_exact and env.num_model > 1
               and mesh_cfg.a2a_policy != "off"
               and hasattr(engine, "a2a_overflow"))

    def rechecked(stacks, period: int = 64):
        for n, stack in enumerate(stacks):
            if recheck and n % period == 0 and n > 0:
                worst = engine.a2a_overflow(stack["ids"][0], 1,
                                            env.num_model,
                                            mesh_cfg.a2a_cap_factor)
                if worst:
                    raise ValueError(
                        f"sharded-embedding a2a overflow mid-stream (stack "
                        f"{n}): {worst} unique ids exceed the per-owner "
                        f"capacity at a2a_cap_factor="
                        f"{mesh_cfg.a2a_cap_factor} — the stream's id "
                        "distribution drifted beyond the startup sample. "
                        "Fix: raise --mesh.a2a_cap_factor or set "
                        "--mesh.a2a_exact=true (lossless).")
            yield stack

    step_fn = spmd.make_spmd_train_step_scanned(
        model, opt, env, global_bs, a2a_exact=a2a_exact,
        a2a_cap_factor=mesh_cfg.a2a_cap_factor)
    eval_logits = spmd.make_spmd_eval_logits(
        model, env, a2a_exact=a2a_exact,
        a2a_cap_factor=mesh_cfg.a2a_cap_factor)

    def run_eval() -> dict[str, float]:
        mstate = M.init_binary_metrics(device=env.device)
        n_done = n_skipped = 0
        batches = iter(eval_batches_fn())
        while n_done < cfg.eval_steps:
            status, hb = _next_agreed(batches, env,
                                      lambda b: len(b["label"]) == bs)
            if status == _ENDED:
                break
            if status == _SKIP:
                n_skipped += 1
                continue
            batch = fast.stage_dataset(hb, env.device)
            logits = eval_logits(ts.params, ts.model_state, batch)
            mstate = M.update_binary_metrics(
                mstate, logits, C.all_gather(batch["label"], env.data))
            n_done += 1
        if n_done == 0:
            raise ValueError(
                f"eval stream produced no batch of the train batch size "
                f"{bs} ({n_skipped} other-sized batches skipped) — metrics "
                "would finalize over zero updates. Make eval_batches_fn "
                "yield the train batch size (stragglers are dropped).")
        if n_skipped:
            log.info("eval: %d straggler batches skipped (size != %d)",
                     n_skipped, bs)
        return M.finalize_binary_metrics(mstate)

    dev_iter = device_prefetch(
        rechecked(itertools.chain([first], stack_iter)), env.device)
    window_steps, loss_v, metrics = done, float("nan"), {}
    next_eval = (done // cfg.eval_every_steps + 1) * cfg.eval_every_steps
    try:
        while done < num_steps:
            status, stack = _next_agreed(dev_iter, env)
            if status != _USE:
                break
            k = min(steps_per_call, num_steps - done)
            if k < steps_per_call:
                stack = {key: v[:k] for key, v in stack.items()}
            ts, loss = step_fn(ts, stack, done)
            done += k
            if done >= next_eval or done >= num_steps:
                loss_v = float(loss)
                rate = out.rate(done - window_steps)
                metrics = run_eval()
                out.report(ts, done, loss_v, rate, metrics, "spmd-stream")
                window_steps = done
                next_eval += cfg.eval_every_steps
    finally:
        dev_iter.close()
        out.close()
    if not metrics:
        metrics = run_eval()
    metrics["train_seconds"] = time.time() - out.t0
    metrics["final_loss"] = loss_v
    metrics["steps_done"] = done
    return metrics
