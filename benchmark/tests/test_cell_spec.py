"""``BENCHMARK.json`` and the files it names: every cell resolves to its
configuration, traffic, limits and per-layer readers; a cell that a later
change adds is found by adding files and an entry, with no code edited; a
run without a card prints no result and fails."""

import glob
import hashlib
import json
import os
import re

import pytest
import torch

from benchmark import compare, run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def _bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_file_keeps_the_contracts_form():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["why"])
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["traffic"]) and _line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e - {"setup_s"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c["config"]["name"] == _bench_config(cell)
    assert callable(spec.kind_module(c).run)
    numbers = compare.compared(c["limits"])
    assert numbers and all(c["limits"][k]["limit"] > 0 for k in numbers)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def _bench_config(cell):
    return next(w["config"] for w in _bench()["workloads"]
                if w["name"] == cell)


def _code_digest():
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                                 recursive=True)):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_a_new_cell_is_found_by_its_files(tiny_cell):
    before = _code_digest()
    cell = tiny_cell("xdeepfm", batch=32, rows=2000)
    assert cell["name"] == "xdeepfm-tiny.train-b32"
    assert cell["traffic"]["batch"] == 32
    assert "cin_roofline" in {m["name"] for m in cell["per_layer"]}
    result = run.run_cell(cell, 5, 0.1, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert _code_digest() == before


def test_a_run_without_a_card_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "deepfm-criteo.train-b1024", "--seed",
                     "1", "--seconds", "1", "--trace", "0"])
    assert code != 0 and capsys.readouterr().out == ""
