"""A cell and everything that belongs to it, found by name.

``BENCHMARK.json`` at the repository's root lists the cells (``workloads``),
their configurations and metrics. Each cell's data are files of their own:

- ``configs/<config>.json`` (the ``file`` of its ``configs`` entry): the
  model configuration as it is run;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, read by the one
  generator (`data.make_dataset`); its ``kind`` names the module that runs
  a cell of that kind of traffic (``benchmark/kinds/<kind>.py``, its
  window and its end-to-end metrics);
- ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``benchmark/metrics/<metric>.py``: the reader of each per-layer metric;
- ``benchmark/models/<model>.py``: the reference of each model.

A cell that a later change adds is one more of each file and one more entry
in ``BENCHMARK.json``: no code here names a cell.
"""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """{'name', 'chips', 'config', 'traffic', 'limits', 'end_to_end',
    'per_layer'} of the cell ``name`` of ``root``'s ``BENCHMARK.json``: the
    metrics the cell reports, each entry as ``BENCHMARK.json`` has it."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; it has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(os.path.join(root, configs[cell["config"]]["file"]))
    here = os.path.join(root, "benchmark")
    traffic = _read(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    limits = _read(os.path.join(here, "limits", name + ".json"))

    def reports(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in e2e_names and reports(m)]
    return {"name": name, "chips": cell["chips"], "config": config,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": per_layer}


def metric_reader(name: str):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    import importlib.util

    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(cell: dict):
    """``benchmark/kinds/<kind>.py`` of the cell's traffic."""
    import importlib

    return importlib.import_module(
        f"benchmark.kinds.{cell['traffic']['kind']}")
