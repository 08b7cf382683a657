"""Multi-process smoke worker (counterpart of
``recsys_tpu/tools/mp_smoke.py``): what a single process cannot show — the
process group across OS processes, per-process input sharding
(`mesh.host_shard_of`) and collectives across processes.

Run one worker per rank, under torchrun or by hand:

    torchrun --nproc_per_node=2 -m recsys_tpu_torch.tools.mp_smoke
    python -m recsys_tpu_torch.tools.mp_smoke --init_method=file:///tmp/f \\
        --world_size=2 --rank=K --device=cpu

``--device`` is ``cuda`` (NCCL, one card a rank; the default) or ``cpu``
(gloo); a collective waits at most ``--timeout_s`` seconds (600). Each
worker prints one JSON line:

- default mode: the psum of every rank's rows (the sum over ranks r of
  4·(r+1)) through `collectives.psum`, and this rank's file shard of 7
  files;
- ``--mode=stream``: each rank streams ITS file shard of the npz shards
  of ``--data_dir`` (``--eval_dir`` for eval) through ``ShardSource`` →
  `spmd_loop.train_and_evaluate_spmd_stream` over a data-parallel mesh
  (DeepFM, 6 fields of 200), ``--num_steps`` steps, checkpoints in
  ``--model_dir``, then reports the eval AUC (``ok``: above 0.58);
- ``--mode=dryrun``: the counterpart of the JAX package's
  ``dryrun_multichip``: fused DeepFM on tiny vocabs (every field on the
  exchange) over a ``(world/2)×2`` mesh (``world×1`` for an odd world):
  one SPMD step, one 3-step call and the sharded eval with its metrics.
"""

from __future__ import annotations

import glob
import json
import math
import os
import sys


def _flags(argv: list[str]) -> dict:
    return dict(a[2:].split("=", 1) for a in argv
                if a.startswith("--") and "=" in a)


def main(argv: list[str] | None = None) -> dict:
    kv = _flags(sys.argv[1:] if argv is None else argv)
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib

    device = mesh_lib.distributed_init(
        kv.get("init_method"),
        int(kv["world_size"]) if "world_size" in kv else None,
        int(kv["rank"]) if "rank" in kv else None,
        cpu=kv.get("device", "cuda") == "cpu",
        timeout_s=float(kv.get("timeout_s", 600)))
    try:
        mode = kv.get("mode", "psum")
        if mode == "stream":
            result = _stream(kv, device)
        elif mode == "dryrun":
            result = _dryrun(device)
        else:
            result = _psum(device)
    finally:
        dist.destroy_process_group()
    print(json.dumps(result), flush=True)
    return result


def _psum(device) -> dict:
    import torch
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.core.config import MeshConfig
    from recsys_tpu_torch.parallel import collectives as C

    env = mesh_lib.make_mesh(MeshConfig(model_axis=1), device)
    rows = torch.full((1, 4), float(env.rank + 1), device=device)
    got = float(C.psum(rows.sum(), env.data))
    expect = float(sum(4 * (r + 1) for r in range(env.world)))
    files = [f"part-{i:02d}" for i in range(7)]
    return {"ok": got == expect, "rank": env.rank,
            "world_size": dist.get_world_size(), "backend":
            dist.get_backend(), "psum": got, "expected": expect,
            "file_shard": mesh_lib.host_shard_of(files)}


def _stream(kv: dict, device) -> dict:
    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.core.config import (CriteoConfig, MeshConfig,
                                              ModelConfig, TrainConfig)
    from recsys_tpu_torch.data import loader
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import spmd_loop

    small = CriteoConfig(cat_vocabs=tuple([200] * 6))
    env = mesh_lib.make_mesh(MeshConfig(model_axis=1), device)
    paths = sorted(glob.glob(os.path.join(kv["data_dir"], "*.npz")))
    eval_paths = sorted(glob.glob(os.path.join(kv["eval_dir"], "*.npz")))
    my_paths = mesh_lib.host_shard_of(paths)
    my_eval = mesh_lib.host_shard_of(eval_paths)
    cfg = TrainConfig(batch_size=128, learning_rate=0.005,
                      model_dir=kv["model_dir"], eval_every_steps=10_000,
                      eval_steps=8)
    src = loader.ShardSource(my_paths, cfg.batch_size, seed=env.rank,
                             num_epochs=-1)

    def eval_batches():
        return loader.ShardSource(my_eval, cfg.batch_size, shuffle=False,
                                  num_epochs=1)

    model = make_model("deepfm", small,
                       ModelConfig(embedding_dim=8, deep_layers=(16, 8)))
    metrics = spmd_loop.train_and_evaluate_spmd_stream(
        model, iter(src), eval_batches, cfg, env=env,
        num_steps=int(kv.get("num_steps", 200)))
    return {"ok": bool(metrics["auc"] > 0.58), "mode": "stream",
            "rank": env.rank, "world_size": env.world,
            "auc": metrics["auc"], "logloss": metrics["logloss"],
            "steps_done": metrics["steps_done"],
            "file_shard": [os.path.basename(p) for p in my_paths]}


def _dryrun(device) -> dict:
    import numpy as np
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.core.config import (CriteoConfig, MeshConfig,
                                              ModelConfig)
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import metrics as M
    from recsys_tpu_torch.train import optim
    from recsys_tpu_torch.train.fast import stage_dataset

    world = dist.get_world_size()
    model_axis = 2 if world % 2 == 0 else 1
    env = mesh_lib.make_mesh(MeshConfig(data_axis=world // model_axis,
                                        model_axis=model_axis), device)
    # tiny vocabs, the real structure; the fused engine puts every field on
    # the sharded exchange
    ccfg = CriteoConfig(cat_vocabs=tuple([64] * 26))
    model = make_model("deepfm", ccfg,
                       ModelConfig(embedding_dim=8, deep_layers=(16, 16),
                                   emb_engine="fused"))
    batch_size = 8 * env.num_data
    host = synthetic_criteo(batch_size, ccfg)
    batch = stage_dataset(spmd.local_rows(host, env), device)
    opt = optim.adam(1e-3)
    ts = spmd.create_spmd_state(model, env, 0, opt)
    step = spmd.make_spmd_train_step(model, opt, env, batch_size)
    ts, loss = step(ts, batch, 0)
    steps = spmd.make_spmd_train_step_scanned(model, opt, env, batch_size)
    stack = {k: np.stack([v] * 3) for k, v in spmd.local_rows(host,
                                                              env).items()}
    ts, loss_k = steps(ts, stage_dataset(stack, device), 1)
    logits = spmd.make_spmd_eval_logits(model, env)(ts.params,
                                                    ts.model_state, batch)
    m = M.finalize_binary_metrics(M.update_binary_metrics(
        M.init_binary_metrics(device=device), logits,
        stage_dataset({"label": host["label"]}, device)["label"]))
    loss_v, loss_k = float(loss), float(loss_k)
    ok = (math.isfinite(loss_v) and math.isfinite(loss_k)
          and 0.0 <= m["auc"] <= 1.0 and math.isfinite(m["logloss"])
          and logits.shape[0] == batch_size)
    return {"ok": ok, "mode": "dryrun", "rank": env.rank,
            "mesh": [env.num_data, env.num_model], "loss": loss_v,
            "loss_3_steps": loss_k, "auc": m["auc"],
            "logloss": m["logloss"]}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
