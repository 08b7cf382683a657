"""Multi-device scaling of the SPMD step over gloo ranks on the CPU
(counterpart of ``recsys_tpu/tools/bench_scaling.py``, whose virtual CPU
mesh becomes one process per rank here).

    python -m recsys_tpu_torch.tools.bench_scaling [--devices=1,2] \
        [--model_axis=2] [--batch_per_device=1024] [--steps=30] \
        [--model=deepfm]

- **Weak scaling**: the SPMD step (``parallel/spmd.py``, K steps a call)
  at a fixed batch per rank over ``('data', 'model')`` meshes of 1, 2, …
  ranks, each a world of gloo processes on this host. The ranks share the
  host's cores, so ex/s is no device's and the efficiency is a lower
  bound; what the table shows is that the step, its collectives included,
  runs and how its cost grows with the world.
- **Collectives** (`measured_collectives`): every collective one SPMD step
  issues, recorded at ``parallel/collectives.py``'s entry points as it
  runs (operation, type, shape, bytes), forward and backward; the JAX
  package reads the same contract from its compiled HLO. The documented
  sizes (`collective_sizes`): the id exchange moves E·cap int32, the rows'
  return E·cap·W float32 each way, not the [B, F, W] activations a psum
  design would move.
- **An analytic model** (`scaling_model`) of a step on H100s from their
  published specifications (not measured: the card's machine has one
  H100, so the wire between cards is unmeasured).

Prints one JSON object.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

#: NVIDIA H100 SXM published NVLink bandwidth per direction (not measured;
#: its memory and float32 peaks are ``utils/profiling.py``'s)
H100_NVLINK_BYTES_PER_S = 450e9
WORKER_TIMEOUT_S = 600.0


def _worker(kv: dict) -> None:
    """One rank: join the gloo world through ``--init``, build the mesh and
    the model's SPMD state, then either time ``--steps`` steps (weak
    scaling) or record one step's collectives (``--collectives=1``); rank
    0 prints its result on a ``WORKER_RESULT`` line."""
    import time

    import numpy as np
    import torch

    from recsys_tpu_torch.core import tree as tree_util
    from recsys_tpu_torch.core.config import (CriteoConfig, MeshConfig,
                                              ModelConfig)
    from recsys_tpu_torch.core.mesh import distributed_init, make_mesh
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.parallel import collectives as C
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import fast, optim

    world, rank = int(kv["world"]), int(kv["rank"])
    torch.set_num_threads(1)
    device = distributed_init(kv["init"], world, rank, cpu=True,
                              timeout_s=WORKER_TIMEOUT_S)
    model_axis = min(int(kv.get("model_axis", 2)), world)
    env = make_mesh(MeshConfig(data_axis=world // model_axis,
                               model_axis=model_axis), device)
    name = kv.get("model", "deepfm")
    bs = int(kv["batch"])
    cap_factor = float(kv.get("cap_factor", 2.0))
    model = make_model(name, CriteoConfig(), ModelConfig(name=name))
    opt = optim.for_model(model.meta, 1e-3)
    ts = spmd.create_spmd_state(model, env, 0, opt)
    steps_fn = spmd.make_spmd_train_step_scanned(
        model, opt, env, bs, a2a_cap_factor=cap_factor)

    data = criteo.synthetic_criteo(max(4 * bs, 16384), CriteoConfig())
    k = 1 if kv.get("collectives") == "1" else min(10, int(kv["steps"]))
    idx = np.random.default_rng(0).integers(0, len(data["label"]), (k, bs))
    stack = fast.stage_dataset(
        spmd.local_rows({key: v[idx] for key, v in data.items()}, env,
                        axis=1), device)
    if kv.get("collectives") == "1":
        with C.recording() as calls:
            ts, loss = steps_fn(ts, stack, 0)
        out = {"collectives": calls,
               "param_elements": sum(
                   t.numel() for t in tree_util.leaves(ts.params)),
               "model_state_elements": sum(
                   t.numel() for t in tree_util.leaves(ts.model_state))}
    else:
        ts, loss = steps_fn(ts, stack, 0)            # warm
        float(loss)
        calls = max(1, int(kv["steps"]) // k)
        t0 = time.perf_counter()
        for c in range(calls):
            ts, loss = steps_fn(ts, stack, k * (c + 1))
        final = float(loss)
        dt = time.perf_counter() - t0
        out = {"devices": world, "model_axis": model_axis, "batch": bs,
               "step_ms": dt / (calls * k) * 1e3,
               "examples_per_s": calls * k * bs / dt, "loss": final}
    if rank == 0:
        print("WORKER_RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def _launch(world: int, args: list[str]) -> dict:
    """Run a world of ``world`` gloo worker processes (a file store in a
    temporary directory, one BLAS thread each) → rank 0's result. Every
    process is killed if the world outlives `WORKER_TIMEOUT_S`."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "recsys_tpu_torch.tools.bench_scaling",
             "--worker=1", f"--world={world}", f"--rank={r}",
             f"--init={init}"] + args, cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        outs = []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
                if p.returncode != 0:
                    raise RuntimeError(f"bench_scaling rank {r} of {world} "
                                       f"exited {p.returncode}:\n"
                                       f"{err[-4000:]}")
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    line = next(ln for ln in outs[0].splitlines()
                if ln.startswith("WORKER_RESULT "))
    return json.loads(line[len("WORKER_RESULT "):])


def measured_collectives(model_axis: int, data_axis: int, batch: int,
                         model_name: str = "deepfm",
                         cap_factor: float = 2.0) -> dict:
    """The collectives of one SPMD step of ``model_name`` at global batch
    ``batch`` on a ``data_axis`` × ``model_axis`` world of gloo ranks, as
    rank 0 issued them: ``{op: [{"dtype", "shape", "bytes"}, ...]}`` (op:
    all-to-all, all-gather, reduce-scatter, all-reduce), and
    ``param_elements`` / ``model_state_elements``: rank 0's parameter and
    BN-stat element counts (the gradient all-reduce carries both, and the
    loss)."""
    res = _launch(model_axis * data_axis, [
        "--collectives=1", f"--model_axis={model_axis}", f"--batch={batch}",
        f"--model={model_name}", f"--cap_factor={cap_factor}", "--steps=1"])
    out: dict = {}
    for c in res["collectives"]:
        out.setdefault(c["op"], []).append(
            {"dtype": c["dtype"], "shape": tuple(c["shape"]),
             "bytes": c["bytes"]})
    out["param_elements"] = res["param_elements"]
    out["model_state_elements"] = res["model_state_elements"]
    return out


def collective_sizes(batch: int, model_axis: int, width: int,
                     cap_factor: float = 2.0) -> dict:
    """Bytes a member sends per step in the sharded embedding's
    all-to-alls (`sharded_embedding.a2a_capacity`) for the Criteo split
    engine's big fields at global batch ``batch``."""
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.embeddings.engines import SPLIT_THRESHOLD
    from recsys_tpu_torch.parallel.sharded_embedding import a2a_capacity

    big_fields = sum(1 for v in CriteoConfig().field_vocab_sizes
                     if v > SPLIT_THRESHOLD)
    n_flat = batch * big_fields
    cap = a2a_capacity(n_flat, model_axis, cap_factor, exact=False)
    return {
        "big_field_ids_per_step": n_flat,
        "a2a_capacity_ids_per_pair": cap,
        "id_exchange_bytes_per_device": model_axis * cap * 4,
        "activation_return_bytes_per_device": model_axis * cap * width * 4,
        "note": ("comms scale with unique ids (dedup before exchange), "
                 "not with the [B,F,D] activation as a psum design would"),
    }


def scaling_model(batch_per_chip: int = 16384, model_axis: int = 1,
                  n_chips: int = 4) -> dict:
    """An analytic per-step model of DeepFM (dim 16) on ``n_chips`` H100s
    from their published specifications (not measured). Per
    card per step: compute ≈ 6·B·Σ(fan_in·fan_out) float32 operations;
    memory: Adam's dense pass over the table and its moments (≈ 7 passes
    of V/model_axis × 17 × 4 B) plus the batch's gathers; NVLink: the
    data-parallel gradient all-reduce of the row-sharded table, 2·(D−1)/D
    × its bytes. The step is the largest of the three; the table terms
    dominate, and both shrink with ``model_axis``."""
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.utils.profiling import (FP32_FLOPS_PER_S,
                                                  HBM_BYTES_PER_S)

    v = CriteoConfig().total_vocab
    w = 17
    b = batch_per_chip
    flops = 6 * b * (624 * 100 + 100 * 100 + 100 * 3 + 39 * 16 * 2)
    hbm = 7 * (v // model_axis) * w * 4 + b * 39 * w * 4 * 3
    data_axis = max(1, n_chips // model_axis)
    wire = 2 * (data_axis - 1) / data_axis * (v // model_axis) * w * 4
    t = {"compute": flops / FP32_FLOPS_PER_S,
         "hbm": hbm / HBM_BYTES_PER_S,
         "nvlink": wire / H100_NVLINK_BYTES_PER_S}
    t_step = max(t.values())
    return {
        "assumptions": "NVIDIA H100 SXM published specifications, not "
                       "measured: 67e12 float32 FLOP/s, 3.35e12 B/s HBM3, "
                       "450e9 B/s NVLink per direction",
        "batch_per_chip": b, "model_axis": model_axis, "n_chips": n_chips,
        "flops_per_step": flops, "hbm_bytes_per_step": hbm,
        "nvlink_bytes_per_step": int(wire),
        "t_compute_ms": t["compute"] * 1e3, "t_hbm_ms": t["hbm"] * 1e3,
        "t_nvlink_ms": t["nvlink"] * 1e3,
        "bound": max(t, key=t.get),
        "predicted_examples_per_s_per_chip": b / t_step,
        "predicted_examples_per_s": n_chips * b / t_step,
    }


def main(argv: list[str] | None = None) -> dict:
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    if "worker" in kv:
        _worker(kv)
        return {}
    devices = [int(d) for d in kv.get("devices", "1,2").split(",")]
    per_device = int(kv.get("batch_per_device", 1024))
    model_axis = int(kv.get("model_axis", 2))
    rows = [_launch(n, [f"--model_axis={model_axis}",
                        f"--batch={per_device * n}",
                        f"--steps={kv.get('steps', 30)}",
                        f"--model={kv.get('model', 'deepfm')}"])
            for n in devices]
    base = rows[0]["examples_per_s"] / rows[0]["devices"]
    for r in rows:
        r["parallel_efficiency"] = r["examples_per_s"] / r["devices"] / base
    result = {
        "weak_scaling": rows,
        "collectives": collective_sizes(
            batch=per_device * max(devices),
            model_axis=min(model_axis, max(devices)), width=17),
        "scaling_model_h100x4": [scaling_model(model_axis=m, n_chips=4)
                                 for m in (1, 2, 4)],
        "caveat": "gloo ranks on one host's CPU cores: efficiency is a "
                  "lower bound and ex/s is no device's",
    }
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
