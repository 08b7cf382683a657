"""The port's run outputs against the JAX package's: checkpoints with
best-metric retention and ``extra`` (bitwise: both packages read and write
the same files), the JSONL scalar stream (equal records apart from
``wall_time``), TensorBoard event files (read back by tensorboard's own
loader), and the files that a short training run of each loop leaves in
``model_dir`` (the same files, the same tags at the same steps, the losses
and eval AUC within 1e-4: float32 sums in another order over a few steps,
as in `tests/test_torch_train.py`)."""

import glob
import json
import os
import runpy

import jax
import numpy as np
import pytest

from recsys_tpu.core.checkpoint import CheckpointManager as JCheckpoints
from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.core.config import TrainConfig as JTrain
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.train import loop as jloop
from recsys_tpu.train import summaries as jsummaries
from recsys_tpu.train import tb_events as jtb
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig, TrainConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train import loop, summaries, tb_events

tb_loader = pytest.importorskip(
    "tensorboard.backend.event_processing.event_file_loader")

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(embedding_dim=4, deep_layers=(8, 8), dropout=0.0)
TOL = 1e-4


def _tree(step):
    """A checkpoint tree of every leaf kind a train state has."""
    rng = np.random.default_rng(step)
    return ({"w": rng.standard_normal((3, 4)).astype(np.float32),
             "layers": [{"b": np.full(2, step, np.float32)}]},
            {"count": np.int32(step)})


# (step, metric, extra): improving, worse, none, tied, improving again
SAVES = [(1, 0.50, {"a": 1}), (2, 0.70, {"a": 2}), (3, 0.60, None),
         (4, None, {"note": "no eval"}), (5, 0.70, {"a": 5}),
         (6, 0.80, {"a": 6}), (7, 0.75, {})]


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _leaves(path) -> dict:
    meta = _meta(path)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {p: z[k] for p, k in meta["manifest"]}


@pytest.mark.parametrize("keep_max", [2, 5])
def test_checkpoint_manager_is_the_jax_manager(tmp_path, keep_max):
    """One sequence of ``save(step, tree, metric, extra)`` calls on each
    package: the same directories, the same ``best/`` (step, metric,
    extra) after every save, and bitwise the same leaves everywhere."""
    port = checkpoint.CheckpointManager(str(tmp_path / "port"), keep_max)
    jax_ = JCheckpoints(str(tmp_path / "jax"), keep_max)
    for step, metric, extra in SAVES:
        port.save(step, _tree(step), metric=metric, extra=extra)
        jax_.save(step, _tree(step), metric=metric, extra=extra)
        assert sorted(os.listdir(tmp_path / "port")) == sorted(
            os.listdir(tmp_path / "jax"))
        got, want = (_meta(tmp_path / who / "best") for who in ("port",
                                                                "jax"))
        assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == ["best"] + [
        f"step_{s}" for s in range(8 - keep_max, 8)]
    assert _meta(tmp_path / "port" / "best")["step"] == 6
    for name in os.listdir(tmp_path / "port"):
        got, want = (_leaves(tmp_path / who / name) for who in ("port",
                                                                "jax"))
        assert got.keys() == want.keys()
        for p in got:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_each_package_restores_the_others_best_and_steps(tmp_path):
    for step, metric, extra in SAVES:
        checkpoint.CheckpointManager(str(tmp_path / "port"), 3).save(
            step, _tree(step), metric=metric, extra=extra)
        JCheckpoints(str(tmp_path / "jax"), 3).save(
            step, _tree(step), metric=metric, extra=extra)
    template = jax.tree.map(np.zeros_like, _tree(0))
    for writer in ("port", "jax"):
        d = str(tmp_path / writer)
        for kw, step, extra in [(dict(best=True), 6, {"a": 6}),
                                (dict(step=5), 5, {"a": 5}),
                                ({}, 7, {})]:
            jtree, jstep, jextra = JCheckpoints(d).restore(template, **kw)
            tree, tstep, textra = checkpoint.CheckpointManager(d).restore(
                template, **kw)
            assert jstep == tstep == step and jextra == textra == extra
            for a, b, c in zip(jax.tree.leaves(jtree),
                               jax.tree.leaves(tree),
                               jax.tree.leaves(_tree(step)), strict=True):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, c)
        assert checkpoint.CheckpointManager(d).restore(step=1) is None
    assert checkpoint.CheckpointManager(
        str(tmp_path / "none")).restore(best=True) is None


def test_the_best_metric_is_read_back_when_a_manager_opens(tmp_path):
    d = str(tmp_path)
    checkpoint.CheckpointManager(d).save(1, _tree(1), metric=0.9)
    # a new manager (a resumed run) keeps the best of the earlier run
    mgr = checkpoint.CheckpointManager(d)
    mgr.save(2, _tree(2), metric=0.8)
    assert _meta(tmp_path / "best")["step"] == 1
    mgr.save(3, _tree(3), metric=0.95, extra={"auc": 0.95})
    assert _meta(tmp_path / "best")["step"] == 3
    assert not glob.glob(str(tmp_path / "*.tmp"))
    assert mgr.restore(best=True)[2] == {"auc": 0.95}


# --------------------------------------------------------------- summaries

def _records(d):
    return [{k: v for k, v in r.items() if k != "wall_time"}
            for r in summaries.read_scalars(d)]


def test_scalar_writer_writes_the_jax_records(tmp_path):
    events = [(10, dict(loss=1.5, examples_per_sec=1e6)),
              (20, dict(eval_auc=0.75, eval_logloss=0.5)),
              (30, dict(loss=np.float32(0.25)))]
    for who, mod in (("port", summaries), ("jax", jsummaries)):
        with mod.ScalarWriter(str(tmp_path / who), tb=False) as w:
            for step, scalars in events:
                w.write(step, **scalars)
    assert _records(tmp_path / "port") == [
        {k: v for k, v in r.items() if k != "wall_time"}
        for r in jsummaries.read_scalars(str(tmp_path / "jax"))]
    assert all("wall_time" in r
               for r in summaries.read_scalars(str(tmp_path / "port")))
    assert summaries.read_scalars(str(tmp_path / "none")) == []


def _load_events(path):
    return list(tb_loader.LegacyEventFileLoader(path).Load())


def _scalars(path):
    return [(v.tag, e.step, v.simple_value) for e in _load_events(path)
            for v in e.summary.value if v.HasField("simple_value")]


def test_crc32c_known_vectors_and_the_jax_crc():
    # RFC 3720's CRC32C (Castagnoli) test vectors
    assert tb_events.crc32c(b"") == 0x0
    assert tb_events.crc32c(b"123456789") == 0xE3069283
    assert tb_events.crc32c(bytes(32)) == 0x8A9136AA
    data = np.random.default_rng(0).bytes(1000)
    assert tb_events.crc32c(data) == jtb.crc32c(data)
    assert tb_events._masked_crc(data) == jtb._masked_crc(data)


def test_event_file_reads_back_in_tensorboard(tmp_path):
    w = tb_events.EventWriter(str(tmp_path))
    w.add_scalar("loss", 0.5, step=1)
    w.add_scalars({"auc": 0.8, "logloss": 0.45}, step=2)
    w.add_histogram("weights", np.linspace(-1, 1, 100), step=2)
    w.close()
    events = _load_events(w.path)
    assert events[0].file_version == "brain.Event:2"
    assert _scalars(w.path) == [("loss", 1, 0.5),
                                ("auc", 2, pytest.approx(0.8)),
                                ("logloss", 2, pytest.approx(0.45))]
    (h,) = [v.histo for e in events for v in e.summary.value
            if v.HasField("histo")]
    assert h.num == 100 and sum(h.bucket) == 100
    assert (h.min, h.max) == (-1.0, 1.0)
    assert len(h.bucket_limit) == len(h.bucket)


def test_scalar_writer_tees_events_and_jsonl_converts(tmp_path, capsys,
                                                      monkeypatch):
    d = str(tmp_path / "run")
    with summaries.ScalarWriter(d) as w:
        w.write(3, loss=2.0, eval_auc=0.5)
        w.write_histogram(3, "emb", np.arange(8.0))
    (path,) = glob.glob(os.path.join(d, "events.out.tfevents.*"))
    assert _scalars(path) == [("loss", 3, 2.0), ("eval_auc", 3, 0.5)]
    converted = tb_events.jsonl_to_events(d)
    assert converted.endswith(".converted")
    assert _scalars(converted) == _scalars(path)
    # the command line: python -m recsys_tpu_torch.train.tb_events <dir>
    monkeypatch.setattr("sys.argv", ["tb_events", d])
    runpy.run_path(tb_events.__file__, run_name="__main__")
    (printed,) = capsys.readouterr().out.split()
    assert printed.endswith(".converted") and _scalars(printed) == _scalars(
        path)


# ------------------------------------------------------ a run's model_dir

def _models(use_bn=True):
    kw = dict(SMALL, name="deepfm", use_bn=use_bn)
    return (jmake("deepfm", JCriteo(cat_vocabs=VOCABS), JModel(**kw)),
            make_model("deepfm", CriteoConfig(cat_vocabs=VOCABS),
                       ModelConfig(**kw)))


def _batches(n, b=64, start=0):
    out = []
    for i in range(n):
        d = jcriteo.synthetic_criteo(b, JCriteo(cat_vocabs=VOCABS),
                                     start_row=start + b * i)
        d["label"] = d["label"].astype(np.float32)
        out.append(d)
    return out


def _run(who, loop_kind, model_dir, jm, tm):
    """A 6-step run of one package's loop from one JAX initial state,
    saved as step 0: eval and a checkpoint at steps 3 and 6."""
    jts, _ = JTS.create_train_state(jm, seed=4, learning_rate=1e-2)
    JCheckpoints(model_dir).save(0, (jts.params, jts.model_state,
                                     jts.opt_state))
    kw = dict(batch_size=64, learning_rate=1e-2, eval_every_steps=3,
              eval_steps=2, log_every_steps=3, seed=4, model_dir=model_dir)
    evald = _batches(2, start=10_000)
    if loop_kind == "host-fed":
        train = _batches(6)
        if who == "jax":
            return jloop.train_and_evaluate(jm, iter(train), lambda: evald,
                                            JTrain(**kw), num_steps=6)
        return loop.train_and_evaluate(tm, iter(train), lambda: evald,
                                       TrainConfig(**kw), num_steps=6,
                                       device="cpu")
    # the fast loop draws its batch indices on the device, from each
    # framework's own generator: every training row is the same row, so
    # every draw gives both the same batch (and the model has no batch
    # norm, whose gradient over identical rows is rounding noise that Adam
    # would scale up to lr)
    row = _batches(1, b=1)[0]
    train = {k: np.repeat(v, 256, axis=0) for k, v in row.items()}
    evals = {k: np.concatenate([b[k] for b in evald]) for k in evald[0]}
    if who == "jax":
        return jloop.train_and_evaluate_fast(jm, train, evals, JTrain(**kw),
                                             num_steps=6, steps_per_call=3)
    return loop.train_and_evaluate_fast(tm, train, evals, TrainConfig(**kw),
                                        num_steps=6, steps_per_call=3,
                                        device="cpu")


def _outputs(model_dir):
    names = os.listdir(model_dir)
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == 1, names
    return sorted(n for n in names if n not in events) + ["<events>"]


@pytest.mark.parametrize("loop_kind", ["host-fed", "fast"])
def test_a_training_run_leaves_the_jax_runs_files(tmp_path, loop_kind):
    jm, tm = _models(use_bn=loop_kind == "host-fed")
    out = {who: _run(who, loop_kind, str(tmp_path / who), jm, tm)
           for who in ("jax", "port")}
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _outputs(port) == _outputs(jax_) == [
        "best", "scalars.jsonl", "step_0", "step_3", "step_6", "<events>"]
    got = summaries.read_scalars(port)
    want = jsummaries.read_scalars(jax_)
    assert [(r["step"], sorted(set(r) - {"wall_time"})) for r in got] == [
        (r["step"], sorted(set(r) - {"wall_time"})) for r in want]
    for g, w in zip(got, want):
        for tag in ("loss", "eval_auc", "eval_logloss"):
            if tag in w:
                np.testing.assert_allclose(g[tag], w[tag], atol=TOL,
                                           err_msg=f"{tag} @ {w['step']}")
    np.testing.assert_allclose(out["port"]["auc"], out["jax"]["auc"],
                               atol=TOL)
    # the event file holds the JSONL's scalars
    (path,) = glob.glob(os.path.join(port, "events.out.tfevents.*"))
    assert sorted((t, s) for t, s, _ in _scalars(path)) == sorted(
        (tag, r["step"]) for r in got for tag in r
        if tag not in ("step", "wall_time"))
    # best/ is the step of the highest eval AUC, the same in both, and the
    # JAX package restores the port's best/ bitwise
    assert _meta(os.path.join(port, "best"))["step"] == _meta(
        os.path.join(jax_, "best"))["step"]
    jts, _ = JTS.create_train_state(jm, seed=0, learning_rate=1e-2)
    template = jax.tree.map(np.asarray, (jts.params, jts.model_state,
                                         jts.opt_state))
    back, step, _ = JCheckpoints(port).restore(template, best=True)
    mine = _leaves(os.path.join(port, "best"))
    assert step == _meta(os.path.join(port, "best"))["step"]
    for (p, leaf), b in zip(mine.items(), jax.tree.leaves(back),
                            strict=True):
        np.testing.assert_array_equal(leaf, b, err_msg=p)


def test_a_port_training_run_keeps_its_best_checkpoint(tmp_path):
    """The fault this slice repairs: a port run left no ``best/``, no
    ``scalars.jsonl`` and no event file where a JAX run leaves all three."""
    _, tm = _models()
    d = str(tmp_path)
    m = loop.train_and_evaluate(
        tm, iter(_batches(4)), lambda: _batches(2, start=5000),
        TrainConfig(batch_size=64, learning_rate=1e-2, eval_every_steps=2,
                    eval_steps=2, log_every_steps=2, model_dir=d),
        num_steps=4, device="cpu")
    assert {"best", "scalars.jsonl"} <= set(os.listdir(d))
    assert glob.glob(os.path.join(d, "events.out.tfevents.*"))
    best = _meta(os.path.join(d, "best"))
    aucs = {r["step"]: r["eval_auc"] for r in summaries.read_scalars(d)
            if "eval_auc" in r}
    assert best["metric"] == max(aucs.values()) and best["step"] in aucs
    assert aucs[4] == m["auc"]
