"""Benchmark: DeepFM Criteo training throughput of the PyTorch port on one
CUDA card — the port's counterpart of the JAX package's ``bench.py``.

    python -m recsys_tpu_torch.tools.bench_train [batch] [steps] [--eager]

Prints one JSON line ``{"metric": "deepfm_criteo_train_examples_per_sec_port",
"value": N, "unit": "examples/s", "device": ...}``. The configuration and
defaults are ``bench.py``'s: the full Criteo feature space (39 fields,
100k-capped hashed vocabs), embedding dim 16, DNN 100-100 with batch norm
and dropout 0.5, TF-parity Adam at lr 1e-3, batch 16384, 200 steps in calls
of K = 50, on a device-resident synthetic dataset of max(4·batch, 65536)
rows with batch indices drawn on the device, each step one CUDA-graph
replay (``--eager``: one kernel at a time from Python, the plain version
it is compared with). One warm-up call (which also builds the kernels and
captures the step) is not timed; the timed calls end on a host read of
the loss. Without a CUDA card it fails.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

K = 50


def main(argv: list[str] | None = None) -> dict:
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    argv = sys.argv[1:] if argv is None else argv
    eager = "--eager" in argv
    argv = [a for a in argv if a != "--eager"]
    batch_size = int(argv[0]) if argv else 16384
    steps = int(argv[1]) if len(argv) > 1 else 200
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: torch.cuda.is_available() is False; "
                         "it measures a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")

    ccfg = CriteoConfig()
    model = make_model("deepfm", ccfg,
                       ModelConfig(embedding_dim=16, deep_layers=(100, 100)))
    ts, tx = TS.create_train_state(model, seed=0, learning_rate=1e-3,
                                   device=device)
    data = criteo.synthetic_criteo(max(4 * batch_size, 65536), ccfg)
    staged = fast.stage_dataset(data, device)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(data["label"]), batch_size, graphed=not eager)

    ts, loss = step_fn(ts, staged, K, 0)  # warm-up: builds, captures
    float(loss)
    calls = max(1, -(-steps // K))       # ceil: honour the requested steps
    t0 = time.perf_counter()
    for c in range(calls):
        ts, loss = step_fn(ts, staged, K, K * (c + 1))
    final_loss = float(loss)             # waits for the last step
    dt = time.perf_counter() - t0
    if not np.isfinite(final_loss):
        raise SystemExit(f"bench_train: loss {final_loss}")
    out = {"metric": "deepfm_criteo_train_examples_per_sec_port",
           "value": batch_size * K * calls / dt, "unit": "examples/s",
           "device": torch.cuda.get_device_name(0), "batch_size": batch_size,
           "steps": K * calls, "final_loss": final_loss,
           "mode": "eager" if eager else "graphed"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
