"""Where a Criteo training step's time goes on one CUDA card.

    python -m recsys_tpu_torch.tools.profile_step [model[:engine] ...] \
        [--batch=16384]

For each model (default: deepfm, deepfm:fused, dcn, fm, dnn:fused, wide)
at full width (``CriteoConfig()``, the model's default ``ModelConfig``;
Adam at lr 1e-3, wide FTRL at alpha 4.0) on a device-resident synthetic
dataset of max(4·batch, 65536) rows, through the devgen fast path
(`fast.make_scanned_train_step_devgen`): one call of 50 steps to warm up,
one timed call of 50 steps (host wall clock, ended by a host read of the
loss), then one call of 10 steps under ``torch.profiler``. Prints one
JSON line per model:

- ``step_ms``: wall time per step of the timed call;
- ``device_ops_per_step``, ``device_busy_ms_per_step``: the count and the
  summed device time of the kernels, copies and fills the profiler saw,
  per step; ``device_idle_share`` = 1 − busy / ``step_ms``;
- ``launch_calls_per_step``: host ``cudaLaunchKernel`` calls per step;
- ``radix_sort_ms_per_step``: the device time per step of the radix
  sort's kernels (those whose name holds ``RadixSort``: the segment sums'
  key sorts);
- ``cin_fwd_ms_per_step`` and ``cin_bwd_ms_per_step``: the device time
  per step of the CIN forward's and the CIN backward's kernels (those
  whose name holds ``cin_fwd`` and ``cin_bwd``; 0 for a model without a
  CIN);
- ``top``: the five device operations with the most time per step.

Without a CUDA card it fails.
"""

from __future__ import annotations

import json
import sys
import time

MODELS = ("deepfm", "deepfm:fused", "dcn", "fm", "dnn:fused", "wide")
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 50, 50, 10


def _spec(arg: str) -> tuple[str, str]:
    name, _, engine = arg.partition(":")
    return name, engine or "split"


def parse(argv: list[str]) -> tuple[list[tuple[str, str]], int]:
    """→ ([(model, engine)], batch size) of the command line."""
    specs, batch = [], 16384
    for a in argv:
        if a.startswith("--batch="):
            batch = int(a.split("=", 1)[1])
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            specs.append(_spec(a))
    return specs or [_spec(m) for m in MODELS], batch


def _device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_model(name: str, engine: str, batch_size: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    device = torch.device("cuda")
    ccfg = CriteoConfig()
    model = make_model(name, ccfg, ModelConfig(name=name, emb_engine=engine))
    lr = 4.0 if model.meta.get("optimizer") == "ftrl" else 1e-3
    ts, tx = TS.create_train_state(model, 0, lr, device)
    data = criteo.synthetic_criteo(max(4 * batch_size, 65536), ccfg)
    staged = fast.stage_dataset(data, device)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(data["label"]), batch_size)

    ts, loss = step_fn(ts, staged, WARMUP_STEPS, 0)
    float(loss)
    t0 = time.perf_counter()
    ts, loss = step_fn(ts, staged, TIMED_STEPS, WARMUP_STEPS)
    float(loss)                              # waits for the last step
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts, loss = step_fn(ts, staged, PROFILED_STEPS,
                           WARMUP_STEPS + TIMED_STEPS)
        float(loss)
        torch.cuda.synchronize()
    ops, busy_us, sort_us, launches, per_op = 0, 0.0, 0.0, 0, []
    cin_us = {"cin_fwd": 0.0, "cin_bwd": 0.0}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = _device_time_us(evt)
            ops += evt.count
            busy_us += us
            sort_us += us if "RadixSort" in evt.key else 0.0
            for k in cin_us:
                cin_us[k] += us if k in evt.key else 0.0
            per_op.append((us, evt.key))
        elif evt.key == "cudaLaunchKernel":
            launches += evt.count
    busy_ms = busy_us / 1e3 / PROFILED_STEPS
    per_op.sort(reverse=True)
    return {"model": name, "engine": engine, "batch_size": batch_size,
            "step_ms": step_ms,
            "examples_per_sec": batch_size / step_ms * 1e3,
            "device_ops_per_step": ops / PROFILED_STEPS,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / step_ms,
            "launch_calls_per_step": launches / PROFILED_STEPS,
            "radix_sort_ms_per_step": sort_us / 1e3 / PROFILED_STEPS,
            **{f"{k}_ms_per_step": us / 1e3 / PROFILED_STEPS
               for k, us in cin_us.items()},
            "top": [[key[:80], us / 1e3 / PROFILED_STEPS]
                    for us, key in per_op[:5]],
            "device": torch.cuda.get_device_name(0)}


def main(argv: list[str] | None = None) -> list[dict]:
    import torch

    specs, batch = parse(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "it measures a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for name, engine in specs:
        out.append(profile_model(name, engine, batch))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
