"""The port's SPMD drivers (``train/spmd_loop.py``) and the command line's
mesh branch on 2 gloo CPU processes (a 1×2 mesh: the tables split over
both), mirroring ``tests/test_spmd_driver.py``.

One launch of ``tests/torch_dist_worker.py`` runs the driver scenarios;
the command-line test launches ``train_ctr train`` itself on 2 ranks.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.core.config import (CriteoConfig, ModelConfig,
                                          TrainConfig)
from recsys_tpu_torch.data import criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train import fast, loop
from recsys_tpu_torch.train.summaries import read_scalars

# the 26 categorical fields of 80 ids; the models below split at 16, so
# all of them go through the sharded exchange
SMALL = CriteoConfig(cat_vocabs=tuple([80] * 26))


@pytest.fixture(scope="module")
def driver(tmp_path_factory):
    io = tmp_path_factory.mktemp("driver")
    paths = criteo.write_synthetic_shards(str(io / "epoch_shards"), 4_000, 2,
                                          SMALL)
    (io / "in.json").write_text(json.dumps({"tmp": str(io),
                                            "epoch_shards": paths}))
    out, res = W.run_cases("driver", str(io), 2, timeout=400)
    return io, out, res


def test_spmd_driver_learns_and_persists(driver):
    """A 2-rank run trains to the AUC floor and leaves the outputs of a
    single-device run: checkpoints of the whole tree in the JAX layout,
    ``best/``, ``scalars.jsonl``. The single-process port restores them
    and computes the eval logits the 2-rank eval computes."""
    io, out, res = driver
    assert res["learn"]["auc"] > 0.58, res["learn"]
    model_dir = str(io / "m")
    for name in ("step_200", "best", "scalars.jsonl"):
        assert os.path.exists(os.path.join(model_dir, name)), name
    scalars = read_scalars(model_dir)
    assert [s["step"] for s in scalars] == [100, 200]
    assert {"loss", "examples_per_sec", "eval_auc",
            "eval_logloss"} <= set(scalars[-1])
    # the resumed run takes no step
    assert np.isnan(res["learn"]["resumed"]["final_loss"])

    model = make_model("deepfm", SMALL, ModelConfig(
        embedding_dim=8, deep_layers=(16, 8), split_threshold=16))
    cfg = TrainConfig(batch_size=256, model_dir=model_dir, eval_steps=8)
    ts = loop.restored_state(model, cfg, "cpu")
    assert int(ts.step) == 200
    held = criteo.synthetic_criteo(4_096, SMALL, start_row=500_000)
    with torch.no_grad():
        logits, _ = model.apply(ts.params, ts.model_state, fast.stage_dataset(
            {k: v[:256] for k, v in held.items()}, "cpu"))
    np.testing.assert_allclose(out["learn_logits"], logits.numpy(),
                               rtol=1e-5, atol=1e-6)
    # and the AUC the 2-rank run logged at step 200, over the same rows
    metrics = loop.evaluate(
        model, ts.params, ts.model_state,
        ({k: v[i * 256:(i + 1) * 256] for k, v in held.items()}
         for i in range(8)), device="cpu")
    assert abs(metrics["auc"] - scalars[-1]["eval_auc"]) < 1e-6
    # the checkpoint is the JAX package's: its big table is W-major
    tree, step, _ = CheckpointManager(model_dir).restore(
        convert.export_params((ts.params, ts.model_state, ts.opt_state)))
    assert step == 200
    assert tree[0]["tables"]["big_wm"].shape == (9, 3072)


def test_a2a_overflow_check_fails_loudly(driver):
    """Skewed ids and policy 'check' (the default) raise before training,
    with the fixes in the message."""
    _, _, res = driver
    err = res["check_error"]
    assert err is not None and "a2a overflow" in err
    assert "--mesh.a2a_cap_factor" in err and "a2a_policy=auto" in err


def test_a2a_overflow_policy_auto_trains_losslessly(driver):
    _, _, res = driver
    assert np.isfinite(res["exact_loss"])
    assert abs(res["auto_loss"] - res["exact_loss"]) < 1e-5, res


def test_spmd_stream_epoch_bound(driver):
    """One epoch of 4,000 rows at batch 256 is 15 batches: one full stack
    of 10 steps, the partial one dropped, and the driver still returns
    metrics."""
    _, _, res = driver
    assert res["epoch"]["steps_done"] == 10
    assert 0.0 <= res["epoch"]["auc"] <= 1.0


def test_mid_stream_overflow_raises_in_the_caller(driver):
    """The 65th stack's ids outgrow the capacity the stream's head fits
    in: the recheck in the prefetcher's thread must raise in the caller
    (on both ranks), not end the run as a clean early stop after 64
    steps."""
    _, _, res = driver
    err = res["drift"]["error"]
    assert err is not None, res["drift"]
    assert "a2a overflow mid-stream (stack 64)" in err


def test_cli_spmd_mesh(tmp_path):
    """``train_ctr train`` under 2 ranks (``WORLD_SIZE=2``) takes the SPMD
    stream driver on a 1×2 mesh and reaches the AUC floor; rank 0 writes
    the checkpoints."""
    data_dir = str(tmp_path / "data")
    criteo.write_synthetic_shards(data_dir, 30_000, 10, SMALL)
    store = tmp_path / "store"
    argv = [sys.executable, "-m", "recsys_tpu_torch.tools.train_ctr", "train",
            "--device=cpu", f"--dist_init=file://{store}",
            f"--data_dir={data_dir}", "--mesh.model_axis=2",
            "--criteo.cat_vocabs=" + ",".join(["80"] * 26),
            "--model.name=deepfm", "--model.embedding_dim=8",
            "--model.deep_layers=16,8", "--model.split_threshold=16",
            "--train.batch_size=256",
            "--train.num_steps=200", "--train.eval_every_steps=100",
            "--train.eval_steps=8", "--train.learning_rate=0.005",
            f"--train.model_dir={tmp_path / 'm'}"]
    outs = W.launch(lambda r: argv, 2, timeout=300,
                    env_of_rank=lambda r: {"WORLD_SIZE": "2",
                                           "RANK": str(r)},
                    cwd=str(tmp_path))
    metrics = [ast.literal_eval(o.strip().splitlines()[-1]) for o in outs]
    for m in metrics:
        assert m["steps_done"] == 200
        assert m["auc"] > 0.58, m
    assert metrics[0]["auc"] == metrics[1]["auc"]
    assert os.path.exists(tmp_path / "m" / "step_200")
