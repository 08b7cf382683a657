"""Where a Criteo training step's time goes on one CUDA card.

    python -m recsys_tpu_torch.tools.profile_step [model[:engine] ...] \
        [--batch=16384] [--eager | --pairs=N]

For each model (default: deepfm, deepfm:fused, dcn, fm, dnn:fused, wide)
at full width (``CriteoConfig()``, the model's default ``ModelConfig``;
Adam at lr 1e-3, wide FTRL at alpha 4.0) on a device-resident synthetic
dataset of max(4·batch, 65536) rows, through the devgen fast path
(`fast.make_scanned_train_step_devgen`): graphed (one CUDA-graph replay a
step, the default), eagerly (``--eager``: one kernel at a time from
Python), or both (``--pairs=N``: two train states from one seed, one per
mode). Each mode takes one call of 50 steps to warm up (the graphed mode's
capture included), then timed calls of 50 steps (host wall clock, ended by
a host read of the loss; with ``--pairs=N``, N pairs of calls, the order
of the two modes alternating from pair to pair), then one call of 10
steps under ``torch.profiler``. Prints one JSON line per model and mode:

- ``step_ms``: wall time per step, the median of the timed calls
  (``step_ms_calls``: each call's);
- ``device_ops_per_step``, ``device_busy_ms_per_step``: the count and the
  summed device time of the kernels, copies and fills the profiler saw,
  per step; ``device_idle_share`` = 1 − busy / ``step_ms``;
- ``launch_calls_per_step``: host ``cudaLaunchKernel`` calls per step;
  ``graph_launches_per_step``: host ``cudaGraphLaunch`` calls per step;
  ``runtime_calls_per_step``: every CUDA runtime call the profiler saw,
  per step, by name;
- ``kernel_ms_per_step``: the device time per step of the port's kernels
  by wrapper (``segment_sum``: the key prep, CUB's radix sort, the chunk
  and carry kernels; ``row_gather``; ``cin_fwd``; ``cin_bwd``: its four
  kernels), each beside the names the profiler gave them
  (``kernel_names``);
- ``radix_sort_ms_per_step``: the part of ``segment_sum`` in the sort's
  kernels (those whose name holds ``RadixSort``);
- ``top``: the five device operations with the most time per step.

Without a CUDA card it fails.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

from recsys_tpu_torch.utils.profiling import device_time_us

MODELS = ("deepfm", "deepfm:fused", "dcn", "fm", "dnn:fused", "wide")
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 50, 50, 10
#: name fragments of each wrapper's kernels in the profiler's trace
KERNELS = {"segment_sum": ("prep_keys", "RadixSort", "segment_chunks",
                           "segment_carry"),
           "row_gather": ("row_gather_kernel",),
           "cin_fwd": ("cin_fwd",),
           "cin_bwd": ("cin_bwd",)}


def _spec(arg: str) -> tuple[str, str]:
    name, _, engine = arg.partition(":")
    return name, engine or "split"


def parse(argv: list[str]) -> tuple[list[tuple[str, str]], int]:
    """→ ([(model, engine)], batch size) of the command line."""
    specs, batch = [], 16384
    for a in argv:
        if a.startswith("--batch="):
            batch = int(a.split("=", 1)[1])
        elif a == "--eager" or a.startswith("--pairs="):
            continue                             # see `parse_modes`
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            specs.append(_spec(a))
    return specs or [_spec(m) for m in MODELS], batch


def parse_modes(argv: list[str]) -> tuple[tuple[str, ...], int]:
    """→ (modes, timed calls of each) of the command line: graphed, 1 by
    default; ``--eager``: eager, 1; ``--pairs=N``: both, N each."""
    pairs = [int(a.split("=", 1)[1]) for a in argv
             if a.startswith("--pairs=")]
    if pairs and "--eager" in argv:
        raise SystemExit("--eager and --pairs exclude each other")
    if pairs:
        if pairs[-1] < 1:
            raise SystemExit(f"--pairs={pairs[-1]}: want at least 1")
        return ("eager", "graphed"), pairs[-1]
    return (("eager",) if "--eager" in argv else ("graphed",)), 1


def profile_call(step_fn, ts, staged, first_step: int):
    """One call of PROFILED_STEPS under torch.profiler → (ts, the
    per-step numbers of its trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ts, loss = step_fn(ts, staged, PROFILED_STEPS, first_step)
        float(loss)
        torch.cuda.synchronize()
    return ts, trace_numbers(prof, PROFILED_STEPS)


def trace_numbers(prof, units: int) -> dict:
    """The numbers of a ``torch.profiler`` trace of ``units`` steps (or
    predicts), per unit: device operations and busy ms, host kernel and
    graph launch calls, every runtime call by name, the port's kernels'
    device ms, and the five largest device operations."""
    from torch.autograd import DeviceType

    per = 1.0 / units
    ops, busy_us, sort_us, per_op, runtime = 0, 0.0, 0.0, [], {}
    kernel_us = dict.fromkeys(KERNELS, 0.0)
    names: dict[str, list[str]] = {k: [] for k in KERNELS}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = device_time_us(evt)
            ops += evt.count
            busy_us += us
            sort_us += us if "RadixSort" in evt.key else 0.0
            for k, frags in KERNELS.items():
                if any(f in evt.key for f in frags):
                    kernel_us[k] += us
                    names[k].append(evt.key[:60])
            per_op.append((us, evt.key))
        elif evt.key.startswith(("cuda", "cu")):
            runtime[evt.key] = runtime.get(evt.key, 0) + evt.count * per
    per_op.sort(reverse=True)
    return {
        "device_ops_per_step": ops * per,
        "device_busy_ms_per_step": busy_us / 1e3 * per,
        "launch_calls_per_step": sum(
            n for k, n in runtime.items()
            if k.startswith(("cudaLaunchKernel", "cuLaunchKernel"))),
        "graph_launches_per_step": sum(
            n for k, n in runtime.items()
            if k.startswith(("cudaGraphLaunch", "cuGraphLaunch"))),
        "runtime_calls_per_step": runtime,
        "kernel_ms_per_step": {k: us / 1e3 * per
                               for k, us in kernel_us.items()},
        "kernel_names": names,
        "radix_sort_ms_per_step": sort_us / 1e3 * per,
        "top": [[key[:80], us / 1e3 * per] for us, key in per_op[:5]]}


def profile_model(name: str, engine: str, batch_size: int,
                  modes: tuple[str, ...] = ("graphed",),
                  calls: int = 1) -> list[dict]:
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    device = torch.device("cuda")
    ccfg = CriteoConfig()
    model = make_model(name, ccfg, ModelConfig(name=name, emb_engine=engine))
    lr = 4.0 if model.meta.get("optimizer") == "ftrl" else 1e-3
    data = criteo.synthetic_criteo(max(4 * batch_size, 65536), ccfg)
    staged = fast.stage_dataset(data, device)
    run = {}
    for mode in modes:
        ts, tx = TS.create_train_state(model, 0, lr, device)
        step_fn = fast.make_scanned_train_step_devgen(
            model, tx, len(data["label"]), batch_size,
            graphed=mode == "graphed")
        ts, loss = step_fn(ts, staged, WARMUP_STEPS, 0)
        float(loss)
        run[mode] = {"ts": ts, "fn": step_fn, "done": WARMUP_STEPS,
                     "ms": []}
    for c in range(calls):
        for mode in (modes if c % 2 == 0 else modes[::-1]):
            r = run[mode]
            t0 = time.perf_counter()
            r["ts"], loss = r["fn"](r["ts"], staged, TIMED_STEPS, r["done"])
            float(loss)                          # waits for the last step
            r["ms"].append((time.perf_counter() - t0) * 1e3 / TIMED_STEPS)
            r["done"] += TIMED_STEPS
    out = []
    for mode in modes:
        r = run[mode]
        r["ts"], prof = profile_call(r["fn"], r["ts"], staged, r["done"])
        step_ms = statistics.median(r["ms"])
        out.append({"model": name, "engine": engine, "mode": mode,
                    "batch_size": batch_size, "step_ms": step_ms,
                    "step_ms_calls": r["ms"],
                    "examples_per_sec": batch_size / step_ms * 1e3,
                    **prof,
                    "device_idle_share":
                        1.0 - prof["device_busy_ms_per_step"] / step_ms,
                    "device": torch.cuda.get_device_name(0)})
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    specs, batch = parse(argv)
    modes, calls = parse_modes(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False; "
                         "it measures a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for name, engine in specs:
        for line in profile_model(name, engine, batch, modes, calls):
            out.append(line)
            print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
