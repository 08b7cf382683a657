"""CTR command line (counterpart of ``recsys_tpu/tools/train_ctr.py``).

    python -m recsys_tpu_torch.tools.train_ctr train --model.name=deepfm \
        --train.batch_size=16384 --train.num_steps=2000 --device=cuda \
        [--data_dir=DIR | --synthetic_rows=N] [--train.model_dir=DIR] \
        [--streaming | --hbm_data_budget=BYTES]
    python -m recsys_tpu_torch.tools.train_ctr eval --data_dir=DIR ...
    python -m recsys_tpu_torch.tools.train_ctr predict --data_dir=DIR ...
    python -m recsys_tpu_torch.tools.train_ctr export --export_dir=./export ...
    python -m recsys_tpu_torch.tools.train_ctr serve --export_dir=./export \
        --device=cuda --port=8500

Every task but ``serve`` reads the ``part-r-*.npz`` shards of
``--data_dir`` (by default synthetic shards of ``--synthetic_rows`` rows
written to ``./synthetic_criteo``) and holds the last tenth of them out
for eval, runs on ``--device`` (``cuda`` or ``cpu``; ``cuda`` without a
card fails) and accepts every ``--section.key=value`` of the run config,
as in the JAX package.

``train`` trains any model of the Criteo zoo (``--model.name`` fm, deepfm,
dcn, xdeepfm, dnn or wide; ``--model.emb_engine`` split or fused; wide
with the FTRL its meta declares, the rest with Adam), with periodic eval
and checkpoints under ``--train.model_dir``, resuming from the latest. A
training set under the device budget (``--hbm_data_budget`` bytes of
shards, 4 GiB by default) is staged on the device
(`loop.train_and_evaluate_fast`); one over it, or any with
``--streaming``, streams from the shards (`loader.ShardSource` through
`loader.device_prefetch` into `loop.train_and_evaluate`). On the card
each step is one CUDA-graph replay either way.

Under ``torchrun --nproc_per_node=N`` (``WORLD_SIZE`` above 1;
``--dist_init=file:///path`` or ``tcp://host:port`` is the rendezvous
in place of torchrun's ``MASTER_ADDR``/``MASTER_PORT``) ``train``
joins the process group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device=cpu``), lays the ranks out as the ``--mesh.data_axis`` ×
``--mesh.model_axis`` mesh and trains through the streaming SPMD driver
(`spmd_loop.train_and_evaluate_spmd_stream`): every rank streams the
global batches of the shards and takes its rows, the tables are split
over the model axis, and rank 0 writes the checkpoints (the whole tree,
in the format a single-device run writes) and scalars.

``eval``, ``predict`` and ``export`` restore the latest checkpoint (fresh
weights, with a warning, when there is none): ``eval`` prints the
streaming metrics over up to ``eval_steps * 10`` held-out batches,
``predict`` the mean probability over the held-out batches, ``export``
writes a servable (the JAX layout: either package loads it).

``serve`` loads the servable (exported by either package: a Criteo model
or DIN, whose ``tools/train_din.py serve`` comes here) on ``--device``
with the batch buckets of ``--buckets=1,8,64,...`` (the JAX package's by
default) and the engine of ``--engine`` (``jit``, the device path, by
default; ``numpy``, the host's straight-line engine for the CTR zoo),
warms every bucket up (on the card: captures its CUDA graph), and serves
on 127.0.0.1: REST on ``--port`` (``0`` binds a free port; the log line
names it), gRPC on port + 1 and the length-prefixed socket on port + 2,
all through one micro-batcher, as the JAX command does. Where ``grpcio``
is not installed, it logs that gRPC is not served and why, and serves the
other two.
"""

from __future__ import annotations

import gc
import glob
import logging
import os
import sys

if __name__ == "__main__" and sys.argv[1:2] == ["serve"]:
    # the host engine's small products must not wake idle BLAS threads:
    # one thread, set before numpy loads its BLAS (as the JAX command does)
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ.setdefault("OMP_NUM_THREADS", "1")

import numpy as np

_TASKS = ("train", "eval", "predict", "export", "serve")
_FLAT = ("data_dir", "export_dir", "port", "device", "synthetic_rows",
         "hbm_data_budget", "buckets", "engine", "dist_init")
_SERVE_FLAGS = ("export_dir", "port", "device", "buckets", "engine")

log = logging.getLogger("recsys_tpu_torch")


def _parse(argv: list[str]):
    """→ (task, flat flags, ``--section.key=value`` overrides, streaming)."""
    task = argv[0] if argv and not argv[0].startswith("--") else "train"
    flat, overrides, streaming = {}, [], False
    for a in argv[1 if argv and argv[0] == task else 0:]:
        if a == "--streaming":
            streaming = True
            continue
        key, eq, value = a[2:].partition("=")
        if not a.startswith("--") or not eq or (
                "." not in key and key not in _FLAT):
            raise SystemExit(f"unsupported argument {a!r}; the port takes "
                             f"--section.key=value, --streaming and "
                             f"--{'=, --'.join(_FLAT)}=")
        if "." in key:
            overrides.append(a)
        else:
            flat[key] = value
    return task, flat, overrides, streaming


def device_from_flag(name: str):
    """The torch device of a ``--device`` flag; ``cuda`` without a card
    exits, it never falls back to the CPU."""
    import torch

    if name not in ("cuda", "cpu"):
        raise SystemExit(f"--device={name}: want cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device=cuda: torch.cuda.is_available() is False")
    # the dense layers' float32 matmuls in full float32, as on the CPU
    # (PyTorch's default, set explicitly: TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(name)


def _serve(kv: dict) -> None:
    from recsys_tpu_torch.serve.export import DEFAULT_BUCKETS, Servable
    from recsys_tpu_torch.serve.fastsock import SocketServer
    from recsys_tpu_torch.serve.server import (make_grpc_server,
                                               make_rest_server)

    device = device_from_flag(kv.get("device", "cuda"))
    try:
        buckets = (tuple(int(b) for b in kv["buckets"].split(","))
                   if "buckets" in kv else DEFAULT_BUCKETS)
        sv = Servable(kv.get("export_dir", "./export"), device=device.type,
                      buckets=buckets, engine=kv.get("engine", "jit"))
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from None
    sv.warmup()
    # the long-lived objects (parameters, graphs, the kernel library) are
    # final: collect once and keep them out of later collections' scans
    gc.collect()
    gc.freeze()
    rest, batcher = make_rest_server(sv, int(kv.get("port", 8500)))
    port = rest.server_address[1]
    try:
        grpc_srv, _ = make_grpc_server(sv, port + 1, batcher)
    except ModuleNotFoundError as e:
        if e.name != "grpc":
            raise
        log.warning("gRPC is not served: %s (the grpcio package is not "
                    "installed)", e)
        grpc_srv = None
    else:
        grpc_srv.start()
    sock = SocketServer(sv, port + 2, batcher)
    sock.start()
    log.info("serving %s on %s (%s engine, buckets %s) at REST:%d gRPC:%s "
             "socket:%d", sv.model_name, device.type, sv.engine,
             ",".join(map(str, sv.buckets)), port,
             port + 1 if grpc_srv is not None else "none", port + 2)
    try:
        rest.serve_forever()
    finally:
        rest.server_close()
        if grpc_srv is not None:
            grpc_srv.stop(0)
        sock.shutdown()
        batcher.stop()


def _load_all(paths: list[str]) -> dict[str, np.ndarray]:
    parts = []
    for p in paths:
        with np.load(p) as z:
            parts.append(dict(z))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _shards(cfg, kv: dict) -> tuple[list[str], list[str]]:
    """(train, eval) shard paths: ``--data_dir``'s, or synthetic shards
    written to ``./synthetic_criteo``; the last tenth held out for eval."""
    from recsys_tpu_torch.data import criteo

    data_dir = kv.get("data_dir")
    if data_dir:
        shard_paths = sorted(glob.glob(f"{data_dir}/part-r-*.npz"))
    else:
        data_dir = "./synthetic_criteo"
        shard_paths = sorted(glob.glob(f"{data_dir}/part-r-*.npz"))
        if not shard_paths:
            shard_paths = criteo.write_synthetic_shards(
                data_dir, int(kv.get("synthetic_rows", 2_000_000)), 20,
                cfg.criteo)
    if len(shard_paths) < 2:
        raise SystemExit(f"{data_dir}: want at least 2 part-r-*.npz shards "
                         "(one for eval)")
    n_eval = max(1, len(shard_paths) // 10)
    return shard_paths[:-n_eval], shard_paths[-n_eval:]


def _train_spmd(model, cfg, kv: dict, device, train_paths, eval_batches,
                num_steps: int) -> dict:
    """``train`` over the world's mesh: every rank streams the global
    batches and takes its rows of each."""
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.data.loader import ShardSource
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import spmd_loop

    dev = mesh_lib.distributed_init(kv.get("dist_init"),
                                    cpu=device.type == "cpu")
    try:
        env = mesh_lib.make_mesh(cfg.mesh, dev)
        src = ShardSource(train_paths, cfg.train.batch_size,
                          seed=cfg.train.seed, num_epochs=-1)
        metrics = spmd_loop.train_and_evaluate_spmd_stream(
            model, (spmd.local_rows(b, env) for b in src),
            lambda: (spmd.local_rows(b, env) for b in eval_batches()),
            cfg.train, cfg.mesh, num_steps=num_steps, env=env)
    finally:
        dist.destroy_process_group()
    print(metrics, flush=True)
    return metrics


def _run_task(task: str, cfg, kv: dict, streaming: bool) -> dict:
    import torch

    from recsys_tpu_torch.data.loader import ShardSource, device_prefetch
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import loop
    from recsys_tpu_torch.train import train_state as TS

    device = device_from_flag(kv.get("device", "cuda"))
    if cfg.model.name == "din":
        raise SystemExit("DIN trains with recsys_tpu_torch.tools.train_din")
    try:
        model = make_model(cfg.model.name, cfg.criteo, cfg.model)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    train_paths, eval_paths = _shards(cfg, kv)

    def eval_batches():
        return ShardSource(eval_paths, cfg.train.batch_size, shuffle=False,
                           num_epochs=1)

    if task == "train":
        num_steps = cfg.train.num_steps
        if num_steps < 0:
            rows = 0
            for p in train_paths:
                with np.load(p) as z:
                    rows += z["label"].shape[0]
            num_steps = cfg.train.num_epochs * rows // cfg.train.batch_size
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            return _train_spmd(model, cfg, kv, device, train_paths,
                               eval_batches, num_steps)
        budget = int(kv.get("hbm_data_budget", 4 << 30))
        if streaming or sum(os.path.getsize(p)
                            for p in train_paths) >= budget:
            src = ShardSource(train_paths, cfg.train.batch_size,
                              seed=cfg.train.seed, num_epochs=-1)
            metrics = loop.train_and_evaluate(
                model, iter(src), eval_batches, cfg.train,
                num_steps=num_steps, device=device)
        else:
            metrics = loop.train_and_evaluate_fast(
                model, _load_all(train_paths), _load_all(eval_paths),
                cfg.train, num_steps=num_steps, device=device)
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
            probs = [predict(ts.params, ts.model_state, b).cpu().numpy()
                     for b in device_prefetch(eval_batches(), device)]
        out = np.concatenate(probs)
        print({"num_predictions": len(out), "mean_prob": float(out.mean())},
              flush=True)
        return {"probs": out}
    from recsys_tpu_torch.serve.export import export_servable
    d = export_servable(kv.get("export_dir", "./export"), cfg.model.name,
                        ts.params, ts.model_state, cfg.model, cfg.criteo)
    print({"export_dir": d}, flush=True)
    return {"export_dir": d}


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    task, kv, overrides, streaming = _parse(
        sys.argv[1:] if argv is None else argv)
    if task not in _TASKS:
        raise SystemExit(f"unknown task {task}")
    if task == "serve":
        extra = sorted(set(kv) - set(_SERVE_FLAGS)) + overrides
        if extra or streaming:
            raise SystemExit(f"serve takes --{'=, --'.join(_SERVE_FLAGS)}=, "
                             f"not {extra or '--streaming'}")
        _serve(kv)
        return {}
    from recsys_tpu_torch.core.config import RunConfig, apply_overrides

    try:
        cfg = apply_overrides(RunConfig(), overrides)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return _run_task(task, cfg, kv, streaming)


if __name__ == "__main__":
    main()
