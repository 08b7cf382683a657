"""The convergence protocol's pieces in the port against the JAX package,
on the CPU at small sizes:

- `optim.cosine_decay` against JAX's for t = 0 … total + 10 (2e-7
  relative, and 2e-7 of the peak where the decay reaches 0: float32 cos
  in another library), and Adam with a schedule and weight decay over 3
  steps (1e-6);
- `synthetic_device.planted_tables` bitwise; the sampler's arithmetic from
  the same draws (ids equal wherever float32 ``u**2.2`` cannot round
  across an integer: XLA's and PyTorch's ``pow`` differ by an ulp; logits
  from the same ids within 1e-5; labels equal away from ties); the
  sampler's marginals against the host generator at the JAX test's
  tolerances;
- the three ceilings and `criteo.synthetic_bayes_metrics` (1e-12), and
  `metrics.roc_auc` against scikit-learn's with ties (1e-12);
- `fast.make_scanned_train_step_sampler` against JAX's over 5 steps with a
  cosine schedule at dropout 0 on one fixed batch (parameters within
  1e-5); on the port's own sampler the loss falls; graphed (stood in for)
  equals eager and a resumed run continues the run it resumes;
- ``tools/converge.py``, tiny: its ceilings equal JAX's on the same slice;
- the committed ``CONVERGENCE_torch.json`` (the card's run) against the
  JAX test's thresholds (``tests/test_results.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.data import synthetic_device as jsd
from recsys_tpu.train import fast as jfast
from recsys_tpu.train import optim as joptim
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data import criteo
from recsys_tpu_torch.data import synthetic_device as sd
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import converge
from recsys_tpu_torch.train import fast, metrics, optim
from recsys_tpu_torch.train import train_state as TS
from test_torch_graph_step import stand_in_graphs  # noqa: F401 (fixture)
from test_torch_train import _assert_trees_close, _models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VOCABS = (200,) * 6
SMALL, JSMALL = (CriteoConfig(cat_vocabs=SMALL_VOCABS),
                 JCriteo(cat_vocabs=SMALL_VOCABS))


@pytest.mark.parametrize("total,warmup,floor", [(100, 10, 0.0),
                                                (37, 0, 0.0),
                                                (500, 20, 0.1)])
def test_cosine_decay_matches_jax(total, warmup, floor):
    peak = 6e-3
    jlr = joptim.cosine_decay(peak, total, warmup_steps=warmup, floor=floor)
    lr = optim.cosine_decay(peak, total, warmup_steps=warmup, floor=floor)
    t = np.arange(total + 11, dtype=np.float32)
    want = np.asarray(jax.jit(jax.vmap(jlr))(jnp.asarray(t)))
    got = lr(torch.from_numpy(t)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-7 * peak)
    assert got[warmup] == pytest.approx(peak, rel=1e-6)
    assert got[total] == pytest.approx(floor * peak, abs=1e-9)


def test_adam_with_a_schedule_and_weight_decay_matches_jax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(4).astype(np.float32)]}
    jtx = joptim.adam(joptim.cosine_decay(0.01, 6, warmup_steps=2),
                      weight_decay=0.05)
    tx = optim.adam(optim.cosine_decay(0.01, 6, warmup_steps=2),
                    weight_decay=0.05)
    jp, js = params, jtx.init(params)
    tp = convert.convert_params(params)
    ts = tx.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        jp, js = jax.jit(jtx.update)(g, js, jp)
        same_p, _ = tx.update(convert.convert_params(g), ts, tp)
        assert same_p is tp                      # in place
    _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-6)
    _assert_trees_close(ts, js, atol=1e-6, rtol=1e-6)


def test_planted_tables_are_bitwise_jax():
    got = sd.planted_tables(SMALL)
    want = jsd.planted_tables(JSMALL)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_sample_from(u, z, ul, monkeypatch):
    """JAX's sampler fed the draws ``u``, ``z``, ``ul``: its random calls
    stood in for, run op by op, with the logit it thresholds recorded."""
    def uniform(key, shape, *a, **k):
        return jnp.asarray(u if tuple(shape) == u.shape else ul)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(z))
    seen = []
    sigmoid = jax.nn.sigmoid

    def recording_sigmoid(x):
        seen.append(np.asarray(x))
        return sigmoid(x)

    monkeypatch.setattr(jax.nn, "sigmoid", recording_sigmoid)
    tabs = {k: jnp.asarray(v) for k, v in jsd.planted_tables(JSMALL).items()}
    with jax.disable_jit():
        b = jsd.make_device_sampler(JSMALL)(jax.random.key(0), tabs,
                                            len(ul))
    return {k: np.asarray(v) for k, v in b.items()}, seen[-1]


def test_sampler_arithmetic_matches_jax_on_the_same_draws(monkeypatch):
    n, f = 4096, len(SMALL.field_vocab_sizes)
    rng = np.random.default_rng(3)
    u = rng.random((n, f), dtype=np.float32)
    z = rng.standard_normal((n, 13), dtype=np.float32)
    ul = rng.random(n, dtype=np.float32)
    want, want_logit = _jax_sample_from(u, z, ul, monkeypatch)

    tabs = sd.device_tables(sd.planted_tables(SMALL), "cpu")
    got = sd.planted_batch(tabs, torch.from_numpy(u), torch.from_numpy(z),
                           torch.from_numpy(ul))
    ids = got["ids"].numpy()
    # ids: equal wherever V·u^2.2 is not within float32 rounding of an
    # integer (there the two libraries' pow may floor to neighbours)
    v = np.asarray(SMALL.field_vocab_sizes, np.float64)
    x = v * u.astype(np.float64) ** 2.2
    edge = np.abs(x - np.round(x)) < 1e-6 * np.maximum(x, 1.0)
    assert edge.mean() < 1e-3
    np.testing.assert_array_equal(ids[~edge], want["ids"][~edge])
    assert (np.abs(ids - want["ids"])[edge] <= 1).all()
    np.testing.assert_allclose(got["dense"].numpy(), want["dense"],
                               rtol=1e-6, atol=1e-6)
    # logits from JAX's ids and dense values
    logit = sd.planted_logit(tabs, torch.from_numpy(
        want["ids"].astype(np.int64)), torch.from_numpy(want["dense"].copy()))
    np.testing.assert_allclose(logit.numpy(), want_logit, atol=1e-5, rtol=0)
    away = np.abs(ul - 1 / (1 + np.exp(-want_logit))) > 1e-5
    same_ids = ~edge.any(axis=1)
    np.testing.assert_array_equal(got["label"].numpy()[away & same_ids],
                                  want["label"][away & same_ids])
    assert 0.1 < want["label"].mean() < 0.5


def test_device_sampler_matches_host_marginals():
    """The JAX test's tolerances (tests/test_synthetic_device.py)."""
    sample = sd.make_device_sampler(SMALL)
    tabs = sd.device_tables(sd.planted_tables(SMALL), "cpu")
    b = sample(torch.Generator().manual_seed(0), tabs, 50_000)
    host = criteo.synthetic_criteo(50_000, SMALL, start_row=999_999)
    assert abs(float(b["label"].mean()) - host["label"].mean()) < 0.01
    assert abs(float(b["dense"].mean()) - host["dense"].mean()) < 0.01
    for f in (0, 13, 15):
        dev_m = float(b["ids"][:, f].double().mean())
        vocab = SMALL.field_vocab_sizes[f]
        assert abs(dev_m - host["ids"][:, f].mean()) < 0.03 * vocab + 0.5
        assert int(b["ids"][:, f].max()) < vocab
    assert b["ids"].dtype == torch.int64


@pytest.mark.parametrize("start_row", [0, 123_457])
def test_ceilings_match_jax(start_row):
    n = 4096
    for port_fn, jax_fn, kw in (
            (criteo.synthetic_bayes_metrics, jcriteo.synthetic_bayes_metrics,
             {}),
            (sd.idonly_bayes_metrics, jsd.idonly_bayes_metrics, {}),
            (sd.linear_bayes_metrics, jsd.linear_bayes_metrics,
             {"mc_samples": 2048, "chunk": 1000})):
        got = port_fn(n, SMALL, start_row=start_row, **kw)
        want = jax_fn(n, JSMALL, start_row=start_row, **kw)
        for k in ("auc", "logloss"):
            assert got[k] == pytest.approx(want[k], abs=1e-12), (port_fn, k)
    lin = sd.linear_bayes_metrics(n, SMALL, start_row=start_row,
                                  mc_samples=2048)
    ido = sd.idonly_bayes_metrics(n, SMALL, start_row=start_row)
    assert lin["auc"] < ido["auc"]
    p = sd.zipf_marginals(200)
    np.testing.assert_array_equal(p, jsd.zipf_marginals(200))


@pytest.mark.parametrize("n,levels", [(1000, 7), (5000, 1000), (333, 2)])
def test_roc_auc_matches_sklearn_with_ties(n, levels):
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(n)
    y = (rng.random(n) < 0.3).astype(np.float32)
    scores = np.round(rng.random(n) * levels + y, 0) / levels   # ties
    assert len(np.unique(scores)) < n
    assert metrics.roc_auc(y, scores) == pytest.approx(
        roc_auc_score(y, scores), abs=1e-12)


def test_sampler_k_step_call_matches_jax():
    """5 steps on one fixed batch (``sample_fn`` returns it every step), a
    cosine schedule, dropout 0: parameters within 1e-5 of JAX's."""
    jm, tm = _models("deepfm", use_bn=True)
    d = jcriteo.synthetic_criteo(256, JCriteo(cat_vocabs=(50,) * 20
                                              + (3000,) * 6), start_row=7)
    jsched = joptim.cosine_decay(3e-3, 5, warmup_steps=2)
    jts, jtx = JTS.create_train_state(jm, seed=3, learning_rate=3e-3,
                                      opt=joptim.adam(jsched))
    port_ts = convert.convert_train_state(jax.tree.map(
        np.asarray, jts._replace(rng=jax.random.key_data(jts.rng))))
    jstep = jfast.make_scanned_train_step_sampler(
        jm, jtx, lambda key, tables, bs: tables, 256)
    jts, jloss = jstep(jts, {k: jnp.asarray(v) for k, v in d.items()}, 5)

    tx = optim.adam(optim.cosine_decay(3e-3, 5, warmup_steps=2))
    step = fast.make_scanned_train_step_sampler(
        tm, tx, lambda gen, tables, bs: tables, 256)
    port_ts, loss = step(port_ts, fast.stage_dataset(d, "cpu"), 5, 0)
    assert int(port_ts.step) == int(jts.step) == 5
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(port_ts.params, jts.params, atol=1e-5, rtol=0)
    _assert_trees_close(port_ts.opt_state, jts.opt_state, atol=1e-6,
                        rtol=1e-3)


def _fm():
    return make_model("fm", SMALL, ModelConfig(name="fm", embedding_dim=8))


def test_sampler_training_learns():
    """The port's own sampler inside the K-step call: the loss falls (the
    JAX package's test_sampler_fused_training_learns)."""
    model = _fm()
    ts, tx = TS.create_train_state(
        model, 0, 5e-3, "cpu",
        opt=optim.adam(optim.cosine_decay(5e-3, 300, warmup_steps=20)))
    tabs = sd.device_tables(sd.planted_tables(SMALL), "cpu")
    step = fast.make_scanned_train_step_sampler(
        model, tx, sd.make_device_sampler(SMALL), 512)
    ts, loss0 = step(ts, tabs, 20, 0)
    ts, loss1 = step(ts, tabs, 280, 20)
    assert float(loss1) < float(loss0) - 0.05, (float(loss0), float(loss1))


def _leaves(ts):
    from recsys_tpu_torch.core import tree
    return tree.leaves((ts.params, ts.model_state, ts.opt_state))


def test_sampler_graphed_equals_eager_and_resumes(stand_in_graphs):
    """Graphs stood in for: the graphed loop and the eager one take the
    same steps bitwise, at dropout 0.5 (the sample first, then the
    masks, from one generator); 3 + 4 steps in two calls equal 7 in one;
    other tables capture anew."""
    model = make_model("deepfm", SMALL, ModelConfig(
        name="deepfm", embedding_dim=4, deep_layers=(8, 8), dropout=0.5))
    tabs = sd.device_tables(sd.planted_tables(SMALL), "cpu")
    other = sd.device_tables(sd.planted_tables(
        SMALL, criteo.SyntheticSpec(seed=1)), "cpu")
    sample = sd.make_device_sampler(SMALL)
    runs = {}
    for graphed, calls in ((False, [(7, tabs)]), (True, [(3, tabs),
                                                         (4, tabs)]),
                           (False, [(3, tabs), (4, tabs)])):
        ts, tx = TS.create_train_state(
            model, 4, 1e-2, "cpu",
            opt=optim.adam(optim.cosine_decay(1e-2, 9, warmup_steps=2)))
        step = fast.make_scanned_train_step_sampler(model, tx, sample, 64,
                                                    graphed=graphed)
        done = 0
        for k, t in calls:
            ts, _ = step(ts, t, k, done)
            done += k
        ts, _ = step(ts, other, 2, done)
        runs[(graphed, len(calls))] = ts
    ref = _leaves(runs[(False, 1)])
    for key in ((True, 2), (False, 2)):
        for a, b in zip(ref, _leaves(runs[key]), strict=True):
            assert torch.equal(a, b), key
    assert int(runs[(True, 2)].step) == 9
    assert stand_in_graphs == ["make_scanned_train_step_sampler"] * 2


def test_converge_tiny_ceilings_equal_jax(tmp_path):
    out = tmp_path / "CONVERGENCE_torch.md"
    result = converge.main(["--device=cpu", "--models=wide",
                            "--examples=6400", "--batch=64",
                            "--eval_rows=2048", f"--out={out}"])
    start = converge.EVAL_START_ROW
    want = {"bayes_ceiling": jcriteo.synthetic_bayes_metrics(
                2048, start_row=start),
            "idonly_ceiling": jsd.idonly_bayes_metrics(2048,
                                                       start_row=start),
            "linear_ceiling": jsd.linear_bayes_metrics(2048,
                                                       start_row=start)}
    with open(tmp_path / "CONVERGENCE_torch.json") as f:
        saved = json.load(f)
    for key, w in want.items():
        for k in ("auc", "logloss"):
            assert saved[key][k] == pytest.approx(w[k], abs=1e-12), key
    (row,) = saved["models"]
    assert row["model"] == "wide" and row["ceiling"] == "linear"
    assert row["examples"] == converge.total_steps(6400, 64) * 64 == 12800
    assert 0.5 < row["auc"] < 1.0
    assert result["card"] == "cpu"
    md = out.read_text()
    assert "| wide |" in md and "ex/s on cpu" in md


def test_the_cards_convergence_run_meets_the_jax_thresholds():
    """The committed ``CONVERGENCE_torch.json``, the card's run of the JAX
    run's protocol, held to the JAX test's thresholds, its ceilings to
    ``CONVERGENCE.json``'s within 1e-9."""
    with open(os.path.join(ROOT, "CONVERGENCE_torch.json")) as f:
        j = json.load(f)
    with open(os.path.join(ROOT, "CONVERGENCE.json")) as f:
        ref = json.load(f)
    assert j["device"] == "cuda" and "H100" in j["card"]
    for key in ("examples", "batch", "eval_rows", "eval_start_row"):
        assert j[key] == ref[key], key
    assert j["dropout"] == 0.0 and j["init"] == "jax"
    for key in ("bayes_ceiling", "idonly_ceiling", "linear_ceiling"):
        for k in ("auc", "logloss"):
            assert j[key][k] == pytest.approx(ref[key][k], abs=1e-9), key
    lin = j["linear_ceiling"]["auc"]
    ido = j["idonly_ceiling"]["auc"]
    full = j["bayes_ceiling"]["auc"]
    assert lin < ido <= full
    gap = full - lin
    assert gap > 0.01
    models = {r["model"]: r for r in j["models"]}
    assert set(models) == set(converge.DEFAULT_MODELS)
    for name in ("wide", "fm", "deepfm", "dcn", "xdeepfm", "dnn"):
        r = models[name]
        assert abs(r["closure"] - (r["auc"] - lin) / gap) < 1e-6
        assert r["examples"] == 403_046_400
    assert abs(models["wide"]["auc"] - lin) < 0.005
    for name in ("fm", "deepfm", "dcn", "xdeepfm", "dnn"):
        assert models[name]["closure"] >= 0.8, (name, models[name])
