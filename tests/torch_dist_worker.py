"""Multi-rank CPU tests of the port: a launcher and the worker it starts.

`launch` starts one process per rank, rendezvousing through a file store
in the test's temporary directory, waits for all of them within its own
time limit (killing every one of them past it) and fails the test with
their output when one fails. `run_cases` runs this file as the worker:

    python tests/torch_dist_worker.py CASE IO_DIR RANK WORLD

Each rank joins a gloo process group (with a timeout of its own, so that a
rank whose peers died does not wait for ever), runs CASE on the inputs the
test wrote to IO_DIR (``in.json``, ``in.npz``), and rank 0 writes
``out.npz`` and ``out.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT_S = 60.0


def launch(argv_of_rank, world: int, timeout: float = 240.0,
           env_of_rank=None, cwd: str = ROOT) -> list[str]:
    """Run ``argv_of_rank(r)`` for every rank r at once (with the
    environment ``env_of_rank(r)`` added, one BLAS thread each) → each
    rank's stdout. Every process is killed after ``timeout`` seconds."""
    procs = []
    for r in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        env.pop("XLA_FLAGS", None)
        env.update(env_of_rank(r) if env_of_rank else {})
        procs.append(subprocess.Popen(
            argv_of_rank(r), cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, (
                f"rank {r} exited {p.returncode}:\n{out[-4000:]}\n"
                f"{err[-8000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_cases(case: str, io_dir: str, world: int,
              timeout: float = 240.0) -> tuple[dict, dict]:
    """Run CASE in ``world`` worker processes → (rank 0's ``out.npz``
    arrays, its ``out.json``)."""
    import numpy as np

    launch(lambda r: [sys.executable, os.path.abspath(__file__), case,
                      io_dir, str(r), str(world)], world, timeout)
    with np.load(os.path.join(io_dir, "out.npz")) as z:
        arrays = dict(z)
    with open(os.path.join(io_dir, "out.json")) as f:
        return arrays, json.load(f)


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------


def _mesh(data: int, model: int):
    from recsys_tpu_torch.core.config import MeshConfig
    from recsys_tpu_torch.core.mesh import make_mesh

    return make_mesh(MeshConfig(data_axis=data, model_axis=model))


def _lookup(inp: dict, arrays: dict, out: dict, res: dict) -> None:
    """Each case: the a2a and psum lookups of a table's shard on the case's
    mesh, their [B, F, W] rows gathered over data, and the table gradient
    of Σ rows² (normalized, summed over data, gathered over model)."""
    import torch
    import torch.distributed as dist

    from recsys_tpu_torch.parallel import collectives as C
    from recsys_tpu_torch.parallel import sharded_embedding as SE
    from recsys_tpu_torch.parallel import spmd

    for case in inp["cases"]:
        key = case["key"]
        env = _mesh(*case["mesh"])
        table = torch.from_numpy(arrays[key + "_table"])
        gids = torch.from_numpy(arrays[key + "_gids"]).to(torch.int64)
        mine = spmd.local_rows({"g": gids}, env)["g"]
        rows = SE.shard_rows_of(table.shape[0], env.num_model)
        shard = table[env.m * rows:(env.m + 1) * rows]
        lookups = {
            "a2a": lambda t: SE.a2a_embedding_lookup(
                t, mine, env.model, cap_factor=case["cap_factor"],
                exact=case["exact"]),
            "psum": lambda t: SE.psum_embedding_lookup(t, mine, env.model),
        }
        for name, fn in lookups.items():
            live = shard.clone().requires_grad_()
            emb = fn(live)
            (g,) = torch.autograd.grad((emb ** 2).sum(), live)
            g = g / env.num_model
            dist.all_reduce(g, group=env.data.group)
            out[f"{key}_{name}"] = C.all_gather(emb.detach(),
                                                env.data).numpy()
            out[f"{key}_{name}_grad"] = C.all_gather(g, env.model).numpy()


def _small_model(name: str, engine: str, lr: float):
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import optim

    small = CriteoConfig(cat_vocabs=tuple([40] * 26))
    model = make_model(name, small, ModelConfig(
        name=name, embedding_dim=8, dropout=0.0, emb_engine=engine,
        split_threshold=16))
    return model, optim.for_model(model.meta, lr)


def _spmd(inp: dict, arrays: dict, out: dict, res: dict) -> None:
    """Each case: one SPMD step (``what='step'``: the whole state after
    it and the loss) or the pre-optimizer gradients (``'grads'``), from
    the seed-0 state or from the checkpoint in ``case['ckpt']``."""
    from recsys_tpu_torch.core import tree as tree_util
    from recsys_tpu_torch.core.checkpoint import CheckpointManager
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import fast, spmd_loop

    for case in inp["cases"]:
        key = case["key"]
        env = _mesh(*case["mesh"])
        model, opt = _small_model(case["model"], case["engine"], case["lr"])
        if case["what"] == "engine":
            _engine_lookup(case, model.meta["engine"], arrays, env, out)
            continue
        ts = spmd.create_spmd_state(model, env, 0, opt)
        if case.get("ckpt"):
            ts = spmd_loop.resume_state(ts, CheckpointManager(case["ckpt"]),
                                        env)
        host = {k[len(case["batch"]) + 1:]: v for k, v in arrays.items()
                if k.startswith(case["batch"] + "_")}
        bsz = len(host["label"])
        batch = fast.stage_dataset(spmd.local_rows(host, env), env.device)
        if case["what"] == "grads":
            loss, _, grads = spmd.loss_and_grads(
                model, ts, batch, 0, env,
                spmd.make_sharded_emb_ops(env, exact=True), bsz)
            whole = spmd.gather_to_host(grads, spmd.param_specs(ts.params),
                                        env)
        else:
            step = spmd.make_spmd_train_step(model, opt, env, bsz,
                                             a2a_exact=True)
            ts, loss = step(ts, batch, 0)
            whole = spmd_loop.whole_state(ts, env)
        if env.rank != 0:       # the gathered trees are rank 0's alone
            continue
        leaves = tree_util.leaves(whole)
        out[f"{key}_loss"] = loss.numpy()
        for i, leaf in enumerate(leaves):
            out[f"{key}_leaf{i}"] = leaf.numpy() if hasattr(
                leaf, "numpy") else leaf
        res[key] = len(leaves)


def _engine_lookup(case, engine, arrays, env, out) -> None:
    """The engine's ``lookup_parts_sharded`` on this rank's rows of a JAX
    engine's parameters (``{key}_p_<leaf>``) and of the batch's ids, the
    (emb, wide) put back into the original field order (as the JAX
    engine's ``lookup_sharded`` returns them) and gathered over data."""
    import numpy as np
    import torch

    from recsys_tpu_torch import convert
    from recsys_tpu_torch.parallel import collectives as C
    from recsys_tpu_torch.parallel import spmd

    key = case["key"]
    whole = convert.convert_params(
        {k[len(key) + 3:]: v for k, v in arrays.items()
         if k.startswith(key + "_p_")})
    params = spmd.shard_tree(whole, spmd.param_specs(whole), env)
    ids = torch.from_numpy(arrays[case["batch"] + "_ids"]).to(torch.int64)
    mine = spmd.local_rows({"ids": ids}, env)["ids"]
    parts = engine.lookup_parts_sharded(params, mine, env.model, exact=True)
    inv = torch.as_tensor(np.argsort(parts.field_order))
    emb = parts.emb_3d(len(inv), parts.emb_2d.shape[1] // len(inv))
    emb, wide = emb.index_select(1, inv), parts.wide.index_select(1, inv)
    out[f"{key}_emb"] = C.all_gather(emb, env.data).numpy()
    out[f"{key}_wide"] = C.all_gather(wide, env.data).numpy()


SKEW = dict(cat_vocabs=tuple([4096] * 4))    # 4 big fields, 13 small


def skewed(n: int, start_row: int = 0) -> dict:
    """Synthetic rows whose big-field ids crowd one owner: the first big
    field all distinct (its rows are shard 0's on a 2-way model axis), the
    others constant (the JAX package's skewed batch)."""
    import numpy as np

    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo

    cfg = CriteoConfig(**SKEW)
    d = criteo.synthetic_criteo(n, cfg, start_row=start_row)
    ids = d["ids"].copy()
    big = [f for f, v in enumerate(cfg.field_vocab_sizes) if v > 96]
    ids[:, big[0]] = np.arange(n) % 4096
    ids[:, big[1:]] = 0
    return dict(d, ids=ids)


def drifting(n: int, early: int):
    """Batches of n rows whose big-field ids repeat (drawn from 64 values)
    for the first ``early`` batches, then are all distinct: a stream whose
    unique ids per owner grow past a capacity its head fits in."""
    import numpy as np

    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo

    cfg = CriteoConfig(**SKEW)
    big = [f for f, v in enumerate(cfg.field_vocab_sizes) if v > 96]
    rng = np.random.default_rng(0)
    for i in range(10 * early):
        d = criteo.synthetic_criteo(n, cfg, start_row=i * n)
        ids = d["ids"].copy()
        ids[:, big] = (rng.integers(0, 64, (n, len(big))) if i < early
                       else (np.arange(n)[:, None] + i * n) % 4096)
        yield dict(d, ids=ids)


def _driver(inp: dict, arrays: dict, out: dict, res: dict) -> None:
    """The SPMD drivers on a 1x2 mesh: training that learns and persists
    (and resumes), the capacity check's 'check' and 'auto', the stream
    bounded by its epoch, and an overflow in the middle of a stream."""
    from recsys_tpu_torch.core.checkpoint import CheckpointManager
    from recsys_tpu_torch.core.config import (CriteoConfig, MeshConfig,
                                              ModelConfig, TrainConfig)
    from recsys_tpu_torch.data import criteo, loader
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import fast, optim, spmd_loop

    tmp = inp["tmp"]
    env = _mesh(1, 2)
    small = CriteoConfig(cat_vocabs=tuple([80] * 26))
    # a 16-vocab split threshold puts the 80-vocab fields on the exchange
    deepfm = ModelConfig(embedding_dim=8, deep_layers=(16, 8),
                         split_threshold=16)

    model = make_model("deepfm", small, deepfm)
    cfg = TrainConfig(batch_size=256, learning_rate=0.005,
                      model_dir=os.path.join(tmp, "m"),
                      eval_every_steps=100, eval_steps=8)
    train = criteo.synthetic_criteo(30_000, small)
    held = criteo.synthetic_criteo(4_096, small, start_row=500_000)
    m1 = spmd_loop.train_and_evaluate_spmd(
        model, train, held, cfg, MeshConfig(model_axis=2), num_steps=200,
        env=env)
    m2 = spmd_loop.train_and_evaluate_spmd(
        model, train, held, cfg, MeshConfig(model_axis=2), num_steps=200,
        env=env)
    ts = spmd.create_spmd_state(model, env, cfg.seed,
                                optim.for_model(model.meta, 0.005))
    ts = spmd_loop.resume_state(ts, CheckpointManager(cfg.model_dir), env)
    rows = {k: v[:256] for k, v in held.items()}
    out["learn_logits"] = spmd.make_spmd_eval_logits(model, env)(
        ts.params, ts.model_state,
        fast.stage_dataset(spmd.local_rows(rows, env), env.device)).numpy()
    res["learn"] = {"auc": m1["auc"], "final_loss": m1["final_loss"],
                    "resumed": {k: float(v) for k, v in m2.items()}}

    skew_model = make_model("deepfm", CriteoConfig(**SKEW), ModelConfig(
        embedding_dim=8, deep_layers=(16, 8), split_threshold=96))
    skew_train = skewed(8_192)
    skew_eval = criteo.synthetic_criteo(1_024, CriteoConfig(**SKEW),
                                        start_row=500_000)

    def skew_run(tag, mesh_cfg, steps=30):
        c = TrainConfig(batch_size=512, learning_rate=0.005,
                        model_dir=os.path.join(tmp, tag),
                        eval_every_steps=100, eval_steps=2)
        return spmd_loop.train_and_evaluate_spmd(
            skew_model, skew_train, skew_eval, c, mesh_cfg, num_steps=steps,
            env=env)

    try:
        skew_run("check", MeshConfig(model_axis=2, a2a_cap_factor=0.25), 20)
        res["check_error"] = None
    except ValueError as e:
        res["check_error"] = str(e)
    res["auto_loss"] = skew_run("auto", MeshConfig(
        model_axis=2, a2a_cap_factor=0.25, a2a_policy="auto"))["final_loss"]
    res["exact_loss"] = skew_run("exact", MeshConfig(
        model_axis=2, a2a_exact=True))["final_loss"]

    fm = make_model("fm", small, ModelConfig(name="fm", embedding_dim=8))
    c = TrainConfig(batch_size=256, learning_rate=0.005,
                    model_dir=os.path.join(tmp, "epoch"),
                    eval_every_steps=1000, eval_steps=4)
    paths = inp["epoch_shards"]
    res["epoch"] = spmd_loop.train_and_evaluate_spmd_stream(
        fm, iter(loader.ShardSource(paths, 256, seed=0, num_epochs=1)),
        lambda: loader.ShardSource(paths, 256, shuffle=False, num_epochs=1),
        c, MeshConfig(model_axis=2), num_steps=10_000, env=env)

    c = TrainConfig(batch_size=256, learning_rate=0.005,
                    model_dir=os.path.join(tmp, "drift"),
                    eval_every_steps=1000, eval_steps=2)
    try:
        m = spmd_loop.train_and_evaluate_spmd_stream(
            skew_model, drifting(256, early=64),
            lambda: iter([skew_eval]), c,
            MeshConfig(model_axis=2, a2a_cap_factor=0.75), num_steps=200,
            steps_per_call=1, env=env)
        res["drift"] = {"error": None, "steps_done": m["steps_done"]}
    except ValueError as e:
        res["drift"] = {"error": str(e)}


CASES = {"lookup": _lookup, "spmd": _spmd, "driver": _driver}


def _worker(case: str, io_dir: str, rank: int, world: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from recsys_tpu_torch.core.mesh import distributed_init
    from recsys_tpu_torch.parallel import spmd

    torch.set_num_threads(1)
    # pieces of a few rows, so that every gather to rank 0's host (the
    # checked states and gradients, the checkpoints) sends many of them
    spmd.GATHER_PIECE_BYTES = 1 << 10
    with open(os.path.join(io_dir, "in.json")) as f:
        inp = json.load(f)
    arrays = {}
    if os.path.exists(os.path.join(io_dir, "in.npz")):
        with np.load(os.path.join(io_dir, "in.npz")) as z:
            arrays = dict(z)
    distributed_init(f"file://{os.path.join(io_dir, 'store')}", world, rank,
                     cpu=True, timeout_s=PG_TIMEOUT_S)
    out: dict = {}
    res: dict = {}
    try:
        CASES[case](inp, arrays, out, res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(io_dir, "out.npz"), **out)
        with open(os.path.join(io_dir, "out.json"), "w") as f:
            json.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
