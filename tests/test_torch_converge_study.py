"""``tools/converge_study.py`` on the CPU, tiny: FM from the JAX run's
and the port's own starting draws, and xDeepFM through the CIN layer and
through the plain CIN patched in its place."""

import json

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops import cin_kernel
from recsys_tpu_torch.tools import converge
from recsys_tpu_torch.tools import converge_study as S

EVAL_ROWS = 1024


@pytest.fixture(autouse=True)
def few_steps_per_call(monkeypatch):
    """4 steps a call, so 256 examples at batch 64 round up to 4 steps,
    not to the protocol's 200: each run trains at full width on the CPU."""
    monkeypatch.setattr(converge, "STEPS_PER_CALL", 4)


@pytest.fixture(scope="module")
def ceilings(tmp_path_factory):
    path = tmp_path_factory.mktemp("ceil") / "ceilings.json"
    path.write_text(json.dumps({"eval_rows": EVAL_ROWS,
                                "eval_start_row": converge.EVAL_START_ROW,
                                **converge.ceilings(EVAL_ROWS)}))
    return path


def _eval_slice():
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo

    return criteo.synthetic_criteo(EVAL_ROWS, CriteoConfig(),
                                   start_row=converge.EVAL_START_ROW)


def _main(tmp_path, ceilings, study, **extra):
    out = tmp_path / "study.json"
    args = ["--device=cpu", f"--study={study}", "--seeds=3",
            "--examples=256", "--batch=64", f"--eval_rows={EVAL_ROWS}",
            f"--ceilings={ceilings}", f"--out={out}"]
    args += [f"--{k}={v}" for k, v in extra.items()]
    result = S.main(args)
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    return result


def test_fm_from_both_starting_draws(tmp_path, ceilings):
    result = _main(tmp_path, ceilings, "fm")
    jax_run, port_run = result["runs"]
    assert (jax_run["start"], port_run["start"]) == ("jax", "port")
    for r in (jax_run, port_run):
        assert r["model"] == "fm" and r["seed"] == 3
        assert r["examples"] == converge.total_steps(256, 64) * 64
        assert 0.0 < r["auc"] < 1.0
        ceil = json.loads(ceilings.read_text())
        lin = ceil["linear_ceiling"]["auc"]
        gap = ceil["bayes_ceiling"]["auc"] - lin
        assert r["closure"] == pytest.approx((r["auc"] - lin) / gap)
    # the two starts differ, so do the trained models
    assert jax_run["auc"] != port_run["auc"]


def test_xdeepfm_through_the_cin_layer_and_the_plain_cin(tmp_path,
                                                         ceilings):
    result = _main(tmp_path, ceilings, "cin")
    layers = result["cin_at_protocol_shape"]
    assert [(r["n"], r["f0"], r["fk"], r["h"]) for r in layers] == [
        (64 * 16, 39, 39, 20), (64 * 16, 39, 20, 10), (64 * 16, 39, 10, 10)]
    # on the CPU the kernels' wrappers run the plain version: the two are
    # one computation, each within float32's reach of float64
    for r in layers:
        for name in ("y", "dx0", "dxk", "dw", "db"):
            e = r[name]
            assert e["kernel_vs_f64"] == e["plain_vs_f64"], name
            assert 0 < e["plain_vs_f64"] < 1e-5 * max(1.0, e["max_abs"])
    kern, plain = result["runs"]
    assert (kern["start"], plain["start"]) == ("jax, CIN kernels",
                                              "jax, plain CIN")
    lin = S.start_lin_dense(3)
    for r in (kern, plain):
        assert r["model"] == "xdeepfm" and r["seed"] == 3
        assert r["cin_kernel_launches"] == [0, 0]       # none on the CPU
        assert 0.0 < r["auc"] < 1.0
        assert 0.0 < r["auc_dense_permuted"] < 1.0
        assert r["dense_live_at_start"] == pytest.approx(np.mean(
            _eval_slice()["dense"] @ lin["w"][:, 0]
            + lin["b"][0] > 0))


def test_plain_cin_replaces_the_layer_and_puts_it_back():
    layer = cin_kernel.cin_layer
    with S.plain_cin():
        assert cin_kernel.cin_layer is cin_kernel.cin_layer_reference
    assert cin_kernel.cin_layer is layer


def test_permuted_dense_keeps_ids_and_labels():
    rng = np.random.default_rng(0)
    data = {"ids": rng.integers(0, 9, (50, 3)), "dense": rng.normal(
        size=(50, 2)), "label": rng.integers(0, 2, 50).astype(np.float32)}
    p = S.permuted_dense(data)
    assert p["ids"] is data["ids"] and p["label"] is data["label"]
    assert not np.array_equal(p["dense"], data["dense"])
    np.testing.assert_array_equal(np.sort(p["dense"], axis=0),
                                  np.sort(data["dense"], axis=0))


def test_the_ceilings_must_be_the_eval_slices(tmp_path, ceilings):
    with pytest.raises(ValueError, match="ceilings are of"):
        S.main(["--device=cpu", "--study=fm", "--eval_rows=2048",
                f"--ceilings={ceilings}", f"--out={tmp_path / 'x.json'}"])


def test_the_study_runs_on_the_card_unless_asked(tmp_path, ceilings):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(SystemExit, match="is_available"):
        S.main(["--study=fm", f"--eval_rows={EVAL_ROWS}",
                f"--ceilings={ceilings}", f"--out={tmp_path / 'x.json'}"])
