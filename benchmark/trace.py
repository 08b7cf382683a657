"""The traced slice of a run: one K-step call under ``torch.profiler``,
reduced to what the per-layer readers (``benchmark/metrics/<name>.py``) and
the result's ``breakdown`` read.

The summary holds plain Python values, so the readers can be tested
without a card:

- ``device_ops``: [(name, start µs, end µs)] of every operation the card
  ran (kernels, copies, fills), from the profiler's device activity;
- ``host_ops``: [(name, start µs, end µs)] of the host's traced operations;
- ``runtime``: {CUDA runtime call: count} on the host;
- ``steps``, ``wall_s`` (host clock from the call to the synchronise after
  it), ``busy_s`` (the union of the device operations' intervals).
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from benchmark import spec

_PEAKS = os.path.join(spec.HERE, "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def card(index: int) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (a copy
    of ``recsys_tpu_torch/utils/profiling.py`` ``card``)."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    float32 operations: the larger of the two over the published peaks."""
    p = peaks()
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["fp32_flops_per_s"])


def profile(call, steps: int) -> dict:
    """Run ``call()`` (one K-step call of ``steps`` steps) twice under
    ``torch.profiler``: the first time to warm the profiler up (its buffers
    are asked for then, not inside the slice), the second traced, and
    synchronise → the second's summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as _profile, schedule

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=1,
                                    repeat=1)) as prof:
        call()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    device_ops, host_ops = [], []
    for evt in prof.events():
        if evt.name.startswith("ProfilerStep"):
            continue        # the schedule's own range, on both tracks
        rng = (evt.name, float(evt.time_range.start),
               float(evt.time_range.end))
        if evt.device_type == DeviceType.CUDA:
            device_ops.append(rng)
        elif evt.device_type == DeviceType.CPU:
            host_ops.append(rng)
    return summarize(device_ops, host_ops, wall, steps)


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(device_ops, host_ops, wall_s: float, steps: int) -> dict:
    runtime: dict[str, int] = {}
    for name, _, _ in host_ops:
        if name.startswith(("cuda", "cu")):
            runtime[name] = runtime.get(name, 0) + 1
    return {"steps": steps, "wall_s": wall_s,
            "busy_s": union_us((s, e) for _, s, e in device_ops) / 1e6,
            "device_ops": device_ops, "host_ops": host_ops,
            "runtime": runtime}


def family_seconds(summary: dict, fragments) -> float:
    """Device seconds of the operations whose name holds one of
    ``fragments``."""
    return sum(e - s for name, s, e in summary["device_ops"]
               if any(f in name for f in fragments)) / 1e6


def breakdown(summary: dict, top: int = 10) -> dict:
    """``device_ops``: the ``top`` device operations by total seconds in the
    slice; ``idle_gaps``: the ``top`` longest stretches in which the card
    ran nothing, each named by the innermost host operation under its
    middle (the traced call's start to its last device operation)."""
    by_op: dict[str, float] = {}
    for name, s, e in summary["device_ops"]:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    dev = sorted((s, e) for _, s, e in summary["device_ops"])
    host = summary["host_ops"]
    gaps = []
    if dev:
        t = min([s for _, s, _ in host] + [dev[0][0]])
        for s, e in dev:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)

    def label(t0, t1):
        mid = (t0 + t1) / 2
        under = [(e - s, name) for name, s, e in host if s <= mid <= e]
        return min(under)[1] if under else "no host operation traced"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[name[:160], sec] for name, sec in ops],
            "idle_gaps": [[label(a, b)[:160], (b - a) / 1e6]
                          for a, b in gaps[:top]]}
