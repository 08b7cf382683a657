"""Fixtures of the benchmark's CPU tests: a checkout of its own in
``tmp_path`` with one tiny cell, whose configuration keeps the Criteo schema
and widths but caps each vocabulary at 3,000 rows, so that the split engine
still has two tables."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import spec

#: the cell whose limits a tiny cell of each model takes
LIMITS_OF = {"deepfm": "deepfm-criteo.train-b16384",
             "xdeepfm": "xdeepfm-criteo.train-b4096"}


def make_root(root, model: str = "deepfm", batch: int = 64,
              rows: int = 3000, steps_per_call: int = 2,
              name: str | None = None) -> str:
    """A checkout at ``root`` holding a copy of ``BENCHMARK.json`` with one
    more cell, its configuration, traffic and limits → the cell's name."""
    here = os.path.join(str(root), "benchmark")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(here, d), exist_ok=True)
    with open(os.path.join(spec.HERE, "configs", f"{model}-criteo.json")) as f:
        config = json.load(f)
    config["name"] = f"{model}-tiny"
    config["cat_vocabs"] = [min(v, 3000) for v in config["cat_vocabs"]]
    config["reduced"] = ["cat_vocabs"]
    with open(os.path.join(here, "configs", f"{model}-tiny.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(spec.HERE, "traffic", "train-b16384.json")) as f:
        traffic = json.load(f)
    traffic.update(rows=rows, batch=batch, steps_per_call=steps_per_call)
    with open(os.path.join(here, "traffic", f"tiny-b{batch}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = name or f"{model}-tiny.train-b{batch}"
    bench["configs"].append({"name": f"{model}-tiny", "source": "test",
                             "file": f"benchmark/configs/{model}-tiny.json",
                             "reduced": ["cat_vocabs"], "why": "test"})
    bench["workloads"].append({"name": name, "config": f"{model}-tiny",
                               "traffic": f"tiny-b{batch}", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    with open(os.path.join(str(root), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(spec.HERE, "limits",
                           LIMITS_OF[model] + ".json")) as f:
        limits = json.load(f)
    with open(os.path.join(here, "limits", name + ".json"), "w") as f:
        json.dump(limits, f)
    return name


@pytest.fixture
def tiny_cell(tmp_path):
    """``load(model='deepfm', **traffic)`` → a tiny cell (`spec.load_cell`)
    of its own checkout in ``tmp_path``."""
    torch.set_num_threads(2)

    def load(model: str = "deepfm", **kwargs) -> dict:
        root = tmp_path / model
        name = make_root(root, model, **kwargs)
        return spec.load_cell(name, str(root))

    return load


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda", 0)
