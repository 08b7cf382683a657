"""The readings that a cell's limits are set from (not run by the
benchmark's own runs):

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process: the cell's set-up as a run makes it
(``prepare`` of its kind's module, `spec.kind_module`: the port's first
three steps through its K-step call), and
three readings of each number that decides ``correct`` against the float32
reference:

- ``program``: the port, the lower reading;
- ``control``: the reference in the port's place computed in TF32, the
  precision below the configuration's float32 (`reference.to_tf32`);
- ``half_batch``: the reference in the port's place with half of each
  batch left out of the mean loss, a fault planted;
- ``reference_fp32_vs_fp64`` and ``program_vs_fp64``: the float32
  reference and the port against a float64 reference, a witness of what
  float32's rounding alone reads.

A state left unchanged reads 1 by the change's and the gradient's measure
and needs no run. Prints one JSON line a seed and one of the extremes: the
largest program reading and the smallest control and fault readings of
each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import compare, spec

def readings(cell: dict, seed: int, device) -> dict:
    """{side: {number: value}, 'at': {side: {number: where}}} of ``seed``,
    the sides as the module's docstring names them."""
    kind = spec.kind_module(cell)
    r = kind.prepare(cell, seed, device)
    del r["ts"], r["steps"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def ref(**options):
        return kind.reference_readings(cell, seed, r, **options)

    fp32, fp64 = ref(), ref(precision="fp64")
    out = {"program": compare.gaps(r["prog"], fp32),
           "control": compare.gaps(ref(precision="tf32"), fp32),
           "half_batch": compare.gaps(ref(fault="half_batch"), fp32),
           "reference_fp32_vs_fp64": compare.gaps(fp32, fp64),
           "program_vs_fp64": compare.gaps(r["prog"], fp64)}
    return {side: {k: v[0] for k, v in found.items()}
            for side, found in out.items()} | {
        "at": {side: {k: v[1] for k, v in found.items()}
               for side, found in out.items()}}


def extremes(lines: list[dict]) -> dict:
    """Of each number: the largest reading of the sound sides, the smallest
    of the control and the fault."""
    low = ("program", "reference_fp32_vs_fp64", "program_vs_fp64")
    return {name: {**{f"{side}_max": max(x[side][name] for x in lines)
                      for side in low},
                   **{f"{side}_min": min(x[side][name] for x in lines)
                      for side in ("control", "half_batch")}}
            for name in lines[0]["program"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"cell": args.workload, "seed": seed,
                **readings(cell, seed, device)}
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"cell": args.workload, "seeds": len(lines),
               "extremes": extremes(lines)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
