"""``tools/results.py`` of the port on the CPU (the JAX package's
``tests/test_results.py`` for the port): a tiny CTR run writes a
well-formed report and ``.json``; a partial rerun keeps the rows and
sections it does not measure; every other section (DIN, the CF family,
serving on the device and in the CPU latency mode) runs at shrunk sizes
and reports each row's device."""

import json
import os

import pytest

from recsys_tpu_torch.tools import results

TINY = ["--device=cpu", "--models=fm", "--batch=512", "--steps=4",
        "--rows=4096", "--din=0", "--cf=0", "--serving=0"]


@pytest.fixture(autouse=True)
def short_calls(monkeypatch):
    """K = 2 steps a call: the tests' runs are a few steps."""
    monkeypatch.setattr(results, "K", 2)


def test_results_tiny(tmp_path):
    out = str(tmp_path / "RESULTS_torch.md")
    result = results.main(TINY + [f"--out={out}"])
    row = result["ctr"][0]
    assert row["model"] == "fm" and row["train_examples_per_s"] > 0
    assert 0.0 <= row["auc"] <= 1.0 and row["device_label"] == "cpu"
    assert result["idonly_ceiling"]["auc"] <= \
        result["bayes_ceiling"]["auc"] + 1e-9
    md = open(out).read()
    assert "| fm |" in md and "(bayes ceiling)" in md
    assert "ex/s on cpu" in md
    with open(os.path.splitext(out)[0] + ".json") as f:
        assert json.load(f)["ctr"][0]["model"] == "fm"


def test_results_partial_rerun_patches_existing(tmp_path):
    out = str(tmp_path / "RESULTS_torch.md")
    jpath = os.path.splitext(out)[0] + ".json"
    results.main(TINY + [f"--out={out}"])
    with open(jpath) as f:
        j = json.load(f)
    j["serving"] = [{"device": "cpu", "protocol": "fake", "batch": 7,
                     "latency_ms_p50": 1.0, "latency_ms_p99": 2.0,
                     "latency_ms_mean": 1.5}]
    j["din"] = {"model": "din", "auc": 0.6, "train_examples_per_s": 9.0,
                "batch": 3}
    j["ctr"].append({"model": "dnn", "auc": 0.5, "logloss": 0.7,
                     "train_examples_per_s": 123.0,
                     "eval_examples_per_s": 456.0, "commit": "abc"})
    with open(jpath, "w") as f:
        json.dump(j, f)
    result = results.main(TINY + [f"--out={out}"])
    models = [r["model"] for r in result["ctr"]]
    assert models == ["fm", "dnn"]                 # the old row kept
    assert result["ctr"][1]["commit"] == "abc"
    assert result["serving"][0]["protocol"] == "fake"
    assert result["din"]["merged_from"] == j["commit"]
    md = open(out).read()
    assert "| dnn |" in md and "fake" in md and "## DIN" in md


def test_results_every_section_at_small_sizes(tmp_path, monkeypatch):
    monkeypatch.setattr(results, "SERVE_TRAIN_ROWS", 16384)
    monkeypatch.setattr(results, "SERVE_TRAIN_STEPS", 2)
    monkeypatch.setattr(results, "SERVE_AUC_ROWS", 1024)
    monkeypatch.setattr(results, "SATURATION",
                        dict(batch=512, clients=2, reqs=2))
    monkeypatch.setattr(results, "LATENCY_ITERS", 3)
    monkeypatch.setattr(results, "DIN_DATA", dict(n_users=2000,
                                                  item_vocab=200,
                                                  cate_vocab=10))
    monkeypatch.setattr(results, "CF_DATA", dict(n_users=600, n_items=150,
                                                 n_heldout_users=60))
    monkeypatch.setattr(results, "CF_EPOCHS", 2)
    monkeypatch.setattr(results, "CDAE_EPOCHS", 2)
    out = str(tmp_path / "R.md")
    result = results.main(["--device=cpu", "--ctr=0", "--batch=256",
                           "--steps=4", "--rows=4096",
                           f"--workdir={tmp_path / 'w'}", f"--out={out}"])
    assert result["ctr"] == []
    din = result["din"]
    assert din["batch"] == 256 and 0.0 <= din["auc"] <= 1.0
    cf = {r["model"]: r for r in result["cf"]}
    assert set(cf) == {"multi_vae", "multi_dae", "logistic_vae", "cdae"}
    assert all(0.0 <= cf[m]["test_ndcg@100"] <= 1.0
               for m in ("multi_vae", "multi_dae", "logistic_vae"))
    protocols = [(r["model"], r["protocol"]) for r in result["serving"]]
    assert ("deepfm-criteo", "rest+encode") in protocols
    assert ("deepfm-criteo", "saturation (2 clients)") in protocols
    assert ("deepfm-demo", "socket raw (numpy)") in protocols
    grpc_rows = [p for _, p in protocols if p.startswith("grpc")]
    assert grpc_rows and all(p.startswith("grpc prepared")
                             for p in grpc_rows)   # grpcio is here
    inproc = [r for r in result["serving"] if r["protocol"].startswith(
        "inproc predict")]
    assert len(inproc) == 2 and "1 BLAS thread" in inproc[0]["protocol"]
    auc = [r["auc"] for r in result["serving"] if "auc" in r]
    assert len(auc) == 1 and 0.0 <= auc[0] <= 1.0
    assert all(r["device"] == "cpu" for r in result["serving"])
    md = open(out).read()
    assert "## Serving" in md and "## CF family" in md


@pytest.mark.parametrize("present", [True, False])
def test_grpc_rows_follow_grpcio(monkeypatch, present):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: (real(name, *a) if present
                                          or name != "grpc" else None))
    assert results._grpc_available() is present
