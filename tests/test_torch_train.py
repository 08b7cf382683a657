"""The port's training path against the JAX package's, on the same numpy
inputs, at a small config (vocabs ``(50,)*20 + (3000,)*6``: 33 small fields
and 6 big ones; embedding dim 4, towers 8-8, CIN 5-3).

- DeepFM logits from converted parameters, eval and train mode at dropout 0
  (tolerance 1e-5: float32 sums in another order);
- every gradient of one DeepFM and one xDeepFM loss, the tables' included,
  against ``jax.grad`` (tolerance 2e-6 absolute + 1e-4 relative: batch
  means of float32 products summed in another order);
- the parameters after 3 optimizer steps on one ``[3, B]`` index matrix
  against JAX ``fast.make_scanned_train_step`` (tolerance 2e-5: Adam's
  first steps move each weight by about lr·sign(g) = 1e-3, so a gradient
  that differs by rounding moves a weight by a few ulps of 1e-3 per step);
- Adam, the streaming metrics, the converter on optimizer and train
  states (the ``AdamState`` NamedTuple), JAX-format checkpoints, and the
  ``train`` command line on the CPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.checkpoint import CheckpointManager as JCheckpoints
from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.train import fast as jfast
from recsys_tpu.train import metrics as jmetrics
from recsys_tpu.train import optim as joptim
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig, TrainConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import train_ctr
from recsys_tpu_torch.train import fast, loop, metrics, optim
from recsys_tpu_torch.train import train_state as TS
from test_torch_xdeepfm import randomize

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(embedding_dim=4, deep_layers=(8, 8), cin_layers=(5, 3),
             dropout=0.0)
GRAD_TOL = dict(atol=2e-6, rtol=1e-4)


def _models(name, **over):
    kw = dict(SMALL, name=name, **over)
    return (jmake(name, JCriteo(cat_vocabs=VOCABS), JModel(**kw)),
            make_model(name, CriteoConfig(cat_vocabs=VOCABS),
                       ModelConfig(**kw)))


def _batch(n, start_row=0):
    d = jcriteo.synthetic_criteo(n, JCriteo(cat_vocabs=VOCABS),
                                 start_row=start_row)
    tb = {"ids": torch.from_numpy(d["ids"].astype(np.int64)),
          "dense": torch.from_numpy(d["dense"]),
          "label": torch.from_numpy(d["label"])}
    return d, tb


def _assert_trees_close(got, want, **tol):
    gl = jax.tree_util.tree_flatten_with_path(convert.export_params(got))[0]
    wl = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    assert [jax.tree_util.keystr(p) for p, _ in gl] == \
        [jax.tree_util.keystr(p) for p, _ in wl]
    for (p, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(p),
                                   **tol)


@pytest.mark.parametrize("train", [False, True])
def test_deepfm_logits_match_jax(train):
    jm, tm = _models("deepfm")
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 1)
    d, tb = _batch(37)
    ref, ref_state = jax.jit(partial(jm.apply, train=train))(
        jparams, jstate, d, rng=jax.random.key(1))
    with torch.no_grad():
        got, got_state = tm.apply(convert.convert_params(jparams),
                                  convert.convert_params(jstate), tb,
                                  train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    _assert_trees_close(got_state, ref_state, atol=1e-5, rtol=1e-5)
    assert float(np.std(np.asarray(ref))) > 0.01


@pytest.mark.parametrize("name", ["deepfm", "xdeepfm"])
def test_gradients_match_jax(name):
    jm, tm = _models(name)
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 2)
    d, tb = _batch(64)

    def jloss(p):
        logits, _ = jm.apply(p, jstate, d, train=True, rng=jax.random.key(1))
        return JTS.sigmoid_ce(logits, d["label"])

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss, _, grads = TS.loss_and_grads(tm, convert.convert_params(jparams),
                                       convert.convert_params(jstate), tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    # the tables' gradients carry the embedding backward: not all zero
    g = convert.export_params(grads)
    assert np.abs(g["tables"]["small"]).max() > 1e-4
    assert np.abs(g["tables"]["big_wm"]).max() > 1e-4
    if name == "xdeepfm":
        assert all(np.abs(c["w"]).max() > 1e-5 for c in g["cin"])


@pytest.mark.parametrize("name", ["deepfm", "xdeepfm"])
def test_three_steps_match_jax(name):
    jm, tm = _models(name, use_bn=True)
    jts, jtx = JTS.create_train_state(jm, seed=3, learning_rate=1e-3)
    port_ts = convert.convert_train_state(jax.tree.map(
        np.asarray, jts._replace(rng=jax.random.key_data(jts.rng))))
    data, _ = _batch(512)
    idx = np.random.default_rng(5).integers(0, 512, (3, 64))

    jts, jloss = jfast.make_scanned_train_step(jm, jtx)(
        jts, jfast.stage_dataset(data), jnp.asarray(idx, jnp.int32))
    steps = fast.make_scanned_train_step(tm, optim.adam(1e-3))
    port_ts, loss = steps(port_ts, fast.stage_dataset(data, "cpu"), idx)

    assert int(port_ts.step) == int(jts.step) == 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(port_ts.params, jts.params, atol=2e-5, rtol=0)
    _assert_trees_close(port_ts.model_state, jts.model_state, atol=1e-5,
                        rtol=1e-5)
    _assert_trees_close(port_ts.opt_state, jts.opt_state, atol=1e-6,
                        rtol=1e-3)


def test_train_on_device_drives_the_devgen_path():
    _, tm = _models("deepfm")
    ts, tx = TS.create_train_state(tm, seed=0, learning_rate=1e-2,
                                   device="cpu")
    data, _ = _batch(2048)
    logged = []
    ts, loss = fast.train_on_device(
        tm, tx, ts, data, batch_size=128, num_steps=60, steps_per_call=20,
        log_every_calls=1, log_fn=lambda *a: logged.append(a))
    assert int(ts.step) == 60 and np.isfinite(loss)
    assert [a[0] for a in logged] == [20, 40, 60]
    assert logged[-1][1] == loss < logged[0][1]


@pytest.mark.parametrize("k", [2, 3])
def test_a_resumed_run_continues_the_run_it_resumes(tmp_path, k):
    """12 steps of DeepFM at dropout 0.5 in one run, and 6 steps, a resume
    from their checkpoint and 6 more, give bitwise the same parameters and
    optimizer state: each step draws its batch indices and dropout masks
    from (seed, step), as the reference folds the step into its key."""
    _, tm = _models("deepfm", dropout=0.5)
    data, _ = _batch(1024)
    evald, _ = _batch(256, start_row=10 ** 6)

    def run(model_dir, num_steps):
        cfg = TrainConfig(batch_size=64, learning_rate=1e-2,
                          eval_every_steps=6, eval_steps=2, seed=5,
                          model_dir=str(model_dir))
        loop.train_and_evaluate_fast(tm, data, evald, cfg,
                                     num_steps=num_steps, device="cpu",
                                     steps_per_call=k)
        # the checkpoint's leaves (params, BN state, Adam state) by name
        with np.load(model_dir / f"step_{num_steps}" / "arrays.npz") as z:
            return {name: z[name] for name in z.files}

    whole = run(tmp_path / "whole", 12)
    first = run(tmp_path / "split", 6)
    split = run(tmp_path / "split", 12)
    assert whole.keys() == split.keys() == first.keys()
    for name in whole:
        np.testing.assert_array_equal(split[name], whole[name], err_msg=name)
    assert any(not np.array_equal(split[n], first[n]) for n in first)


def test_step_draws_depend_on_seed_and_step_only():
    _, tm = _models("deepfm")
    ts, _ = TS.create_train_state(tm, seed=9, learning_rate=1e-3,
                                  device="cpu")

    def draw(step):
        TS.reseed(ts, step)
        return torch.randint(0, 1 << 30, (8,), generator=ts.rng)

    a = draw(4)
    draw(5)
    assert torch.equal(draw(4), a)
    assert not torch.equal(draw(5), a)
    assert TS.step_seed(9, 4) != TS.step_seed(10, 4)
    assert 0 <= TS.step_seed(2 ** 63 - 1, 2 ** 40) < 2 ** 63


def test_adam_update_matches_jax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    jtx, tx = joptim.adam(0.01), optim.adam(0.01)
    jp, js = params, jtx.init(params)
    tp = convert.convert_params(params)
    ts = tx.init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        jp, js = jtx.update(g, js, jp)
        same_p, same_s = tx.update(convert.convert_params(g), ts, tp)
        assert same_p is tp and same_s is ts       # updated in place
    _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
    _assert_trees_close(ts, js, atol=1e-6, rtol=1e-6)


def test_binary_metrics_match_jax():
    rng = np.random.default_rng(1)
    js, ts = jmetrics.init_binary_metrics(), metrics.init_binary_metrics()
    for _ in range(3):
        logits = (2 * rng.standard_normal(300)).astype(np.float32)
        labels = (rng.random(300) < 0.3).astype(np.float32)
        js = jax.jit(jmetrics.update_binary_metrics)(
            js, jnp.asarray(logits), jnp.asarray(labels))
        ts = metrics.update_binary_metrics(ts, torch.from_numpy(logits),
                                           torch.from_numpy(labels))
    want, got = jmetrics.finalize_binary_metrics(js), \
        metrics.finalize_binary_metrics(ts)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k


def test_convert_round_trips_the_adam_and_train_state():
    jm, _ = _models("xdeepfm")
    jts, _ = JTS.create_train_state(jm, seed=0, learning_rate=1e-3)
    host = jax.tree.map(np.asarray,
                        jts._replace(rng=jax.random.key_data(jts.rng)))
    opt = convert.convert_params(host.opt_state)
    assert type(opt).__name__ == "AdamState" and opt._fields == (
        "count", "mu", "nu")
    assert tuple(opt.mu["tables"]["big"].shape) == \
        host.opt_state.mu["tables"]["big_wm"].shape[::-1]
    back = convert.export_params(opt)
    assert type(back) is type(host.opt_state)
    _assert_trees_close(opt, host.opt_state, atol=0, rtol=0)

    ts = convert.convert_train_state(host)
    assert isinstance(ts, TS.TrainState) and int(ts.step) == 0
    assert isinstance(ts.rng, torch.Generator)
    _assert_trees_close(ts.params, host.params, atol=0, rtol=0)
    # converted tensors own their memory: in-place training leaves the
    # caller's arrays alone
    ts.params["final"]["w"].add_(1.0)
    assert not np.array_equal(ts.params["final"]["w"].numpy(),
                              host.params["final"]["w"])


def test_checkpoint_paths_and_template_restore(tmp_path):
    jm, tm = _models("deepfm")
    jts, _ = JTS.create_train_state(jm, seed=0, learning_rate=1e-3)
    ts, _ = TS.create_train_state(tm, seed=0, learning_rate=1e-3,
                                  device="cpu")
    jtree = (jts.params, jts.model_state, jts.opt_state)
    tree = convert.export_params((ts.params, ts.model_state, ts.opt_state))
    assert [p for p, _ in checkpoint.flatten(tree)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(7, tree, metric=0.5)
    restored, step = mgr.restore(tree)
    assert step == 7 and type(restored[2]) is type(tree[2])
    _assert_trees_close(convert.convert_params(restored), tree, atol=0,
                        rtol=0)
    with pytest.raises(ValueError):
        mgr.restore((tree[0], tree[1]))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A training checkpoint that the JAX package wrote resumes the port's
    loop, and one that the port wrote restores in the JAX package."""
    jm, tm = _models("xdeepfm")
    jts, _ = JTS.create_train_state(jm, seed=0, learning_rate=1e-3)
    jtree = jax.tree.map(np.asarray,
                         (jts.params, jts.model_state, jts.opt_state))
    JCheckpoints(str(tmp_path / "jax")).save(5, jtree, metric=0.7)
    ts, _ = TS.create_train_state(tm, seed=1, learning_rate=1e-3,
                                  device="cpu")
    ts = loop._resume(ts, checkpoint.CheckpointManager(str(tmp_path / "jax")))
    assert int(ts.step) == 5
    mine = (ts.params, ts.model_state, ts.opt_state)
    _assert_trees_close(mine, jtree, atol=0, rtol=0)
    checkpoint.CheckpointManager(str(tmp_path / "port")).save(
        6, convert.export_params(mine))
    back, step, _ = JCheckpoints(str(tmp_path / "port")).restore(jtree)
    assert step == 6
    _assert_trees_close(mine, back, atol=0, rtol=0)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    data_dir, model_dir = tmp_path / "data", tmp_path / "model"
    jcriteo.write_synthetic_shards(str(data_dir), 4000, 4,
                                   JCriteo(cat_vocabs=VOCABS))
    argv = ["train", "--model.name=deepfm", "--device=cpu",
            f"--data_dir={data_dir}", f"--train.model_dir={model_dir}",
            "--model.embedding_dim=4", "--model.deep_layers=8,8",
            f"--criteo.cat_vocabs={','.join(map(str, VOCABS))}",
            "--train.batch_size=128", "--train.num_steps=12",
            "--train.eval_every_steps=6", "--train.eval_steps=4",
            "--train.learning_rate=0.01"]
    out = train_ctr.main(argv)
    assert 0.0 <= out["auc"] <= 1.0 and out["count"] == 4 * 128
    assert np.isfinite(out["final_loss"])
    assert "'auc'" in capsys.readouterr().out
    mgr = checkpoint.CheckpointManager(str(model_dir))
    assert mgr.latest_step() == 12
    # a second run resumes at step 12 and trains to 18
    out = train_ctr.main(argv[:-4] + ["--train.num_steps=18"] + argv[-3:])
    assert mgr.latest_step() == 18 and np.isfinite(out["final_loss"])


@pytest.mark.parametrize("argv", [
    ["train", "--device=tpu"],
    ["train", "--device=cpu", "--model.name=autoint"],
])
def test_train_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit, match="not ported|want cuda or cpu"):
        train_ctr.main(argv)
