"""Run one cell of the benchmark on one card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The module of the cell's kind of traffic
(``benchmark/kinds/<kind>.py``, `spec.kind_module`) runs it: set-up (the
data and weights made on the card from ``--seed``, every shape the window
uses built; ``setup_s`` counts from the process's start), the window of
``--seconds``, with ``--trace 1`` one more slice under ``torch.profiler``
whose per-layer metrics the readers of ``benchmark/metrics/`` take, and
the comparison with the plain reference that decides ``correct``.

The last line of standard output is the result, as JSON; the last lines of
standard error are the numbers compared, each beside its limit. Without a
card, or with fewer cards than the cell asks for, or with the JAX package
loaded, the run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import spec

#: build and kernel caches, each at a fixed path inside the checkout
_CACHE = os.path.join(spec.ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)

import torch  # noqa: E402  (after the cache directories are set)

from benchmark import trace  # noqa: E402

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "recsys_tpu")


def seconds_since_start() -> float:
    """Seconds since this process started (``/proc``: the start in clock
    ticks since boot against the uptime, both to 10 ms)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole:
    ``recsys_tpu_torch`` is not ``recsys_tpu``."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             started: float | None = None) -> dict:
    """Run ``cell`` (`spec.load_cell`) on ``device`` by the module of its
    traffic's kind (`spec.kind_module`) → the result, with ``checks``
    last. ``started``: the host clock's reading at the process's start,
    for ``setup_s`` (now, when None)."""
    t_start = time.perf_counter() if started is None else started
    out = spec.kind_module(cell).run(cell, seed, seconds, traced, device,
                                     t_start)
    summary = out["summary"]
    if traced:
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["ok"] and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["wall_s"]
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = out["checks"]
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = time.perf_counter() - seconds_since_start()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark "
              "measures a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, started)
    result["device"]["card"] = trace.card(0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}; the port's benchmark may "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r}, "
              f"{c['at']}): {'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
