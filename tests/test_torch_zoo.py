"""The rest of the Criteo zoo in the port against the JAX package — FM, DCN,
DNN and the wide linear model on the split engine, DeepFM and DNN on the
fused engine — on the same numpy inputs, at a small config (vocabs
``(50,)*20 + (3000,)*6``, embedding dim 4, towers 8-8, 2 cross layers,
dropout 0), parameters converted with ``convert.convert_params``:

- logits, eval and train mode (tolerance 1e-5: float32 sums in another
  order);
- every gradient of one loss, the tables' included, against ``jax.grad``
  (tolerance 2e-6 absolute + 1e-4 relative, as in tests/test_torch_train.py);
- the parameters after 3 optimizer steps against JAX
  ``fast.make_scanned_train_step`` (tolerance 2e-5; the optimizer state
  1e-6 absolute + 1e-3 relative): Adam, or FTRL for ``wide`` on both
  sides, each picked by ``optim.for_model``;
- one FTRL update against ``recsys_tpu.train.optim.ftrl``;
- servables of ``dcn`` and ``wide`` exported by either package, loaded by
  the other;
- ``train_ctr train`` on the CPU for dcn, wide and fused-engine DeepFM;
- the three repaired faults: the entry points default to the card, the
  train state takes the optimizer the model declares, and the MLP of
  DeepFM and DNN takes ``emb_2d`` when the engine gives no parts.
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
from recsys_tpu.ops import interactions as jinteractions
from recsys_tpu.serve import export as jexport
from recsys_tpu.train import fast as jfast
from recsys_tpu.train import optim as joptim
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core.config import (CriteoConfig, EmbeddingConfig,
                                          ModelConfig)
from recsys_tpu_torch.embeddings import engines
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.models import api
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import interactions
from recsys_tpu_torch.serve import export
from recsys_tpu_torch.tools import profile_step, train_ctr
from recsys_tpu_torch.train import fast, optim
from recsys_tpu_torch.train import train_state as TS
from test_torch_train import GRAD_TOL, _assert_trees_close
from test_torch_xdeepfm import randomize

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(embedding_dim=4, deep_layers=(8, 8), cross_layers=2,
             dropout=0.0)
CASES = [("fm", "split"), ("dcn", "split"), ("dnn", "split"),
         ("wide", "split"), ("deepfm", "fused"), ("dnn", "fused")]
CASE_IDS = [f"{n}-{e}" for n, e in CASES]
#: FTRL's alpha operates on batch-mean gradients: an Adam-sized lr would
#: leave the wide weights at ~1e-5 and the comparison void
LR = {"wide": 0.5}


def _models(name, engine="split", **over):
    kw = dict(SMALL, name=name, emb_engine=engine, **over)
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


def _table_grads(g: dict) -> list:
    """The table gradients of an exported gradient tree."""
    if "wide" in g:
        return [g["wide"]["w"]]
    t = g["tables"]
    return [t["table_flat"]] if "table_flat" in t else [t["small"],
                                                        t["big_wm"]]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,engine", CASES, ids=CASE_IDS)
def test_port_init_has_the_jax_tree_layout(name, engine):
    jm, tm = _models(name, engine)
    j = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    t = convert.export_params(tm.init(torch.Generator().manual_seed(0),
                                      "cpu"))
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    tl = jax.tree_util.tree_flatten_with_path(t)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            jax.tree_util.keystr(p)
    assert tm.meta["emb_width"] == SMALL["embedding_dim"] + 1
    assert tm.meta.get("optimizer") == jm.meta.get("optimizer")


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,engine", CASES, ids=CASE_IDS)
def test_logits_match_jax(name, engine, train):
    jm, tm = _models(name, engine)
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 1)
    d, tb = _batch(37)
    ref, ref_state = jax.jit(partial(jm.apply, train=train))(
        jparams, jstate, d, rng=jax.random.key(1))
    with torch.no_grad():
        got, got_state = tm.apply(convert.convert_params(jparams),
                                  convert.convert_params(jstate), tb,
                                  train=train)
    assert got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    _assert_trees_close(got_state, ref_state, atol=1e-5, rtol=1e-5)
    assert float(np.std(np.asarray(ref))) > 0.01


@pytest.mark.parametrize("name,engine", CASES, ids=CASE_IDS)
def test_gradients_match_jax(name, engine):
    jm, tm = _models(name, engine)
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
    # the table gradients carry the embedding backward: not all zero
    for g in _table_grads(convert.export_params(grads)):
        assert np.abs(g).max() > 1e-4


@pytest.mark.parametrize("name,engine", CASES, ids=CASE_IDS)
def test_three_steps_match_jax(name, engine):
    jm, tm = _models(name, engine, use_bn=True)
    lr = LR.get(name, 1e-3)
    jts, jtx = JTS.create_train_state(jm, seed=3, learning_rate=lr)
    port_ts = convert.convert_train_state(jax.tree.map(
        np.asarray, jts._replace(rng=jax.random.key_data(jts.rng))))
    data, _ = _batch(512)
    idx = np.random.default_rng(5).integers(0, 512, (3, 64))

    jts, jloss = jfast.make_scanned_train_step(jm, jtx)(
        jts, jfast.stage_dataset(data), jnp.asarray(idx, jnp.int32))
    tx = optim.for_model(tm.meta, lr)
    port_ts, loss = fast.make_scanned_train_step(tm, tx)(
        port_ts, fast.stage_dataset(data, "cpu"), idx)

    assert type(port_ts.opt_state).__name__ == (
        "FtrlState" if name == "wide" else "AdamState")
    assert int(port_ts.step) == int(jts.step) == 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(port_ts.params, jts.params, atol=2e-5, rtol=0)
    _assert_trees_close(port_ts.model_state, jts.model_state, atol=1e-5,
                        rtol=1e-5)
    _assert_trees_close(port_ts.opt_state, jts.opt_state, atol=1e-6,
                        rtol=1e-3)
    # the steps moved the tables
    for g in _table_grads(convert.export_params(port_ts.params)):
        assert np.abs(g).max() > 0


@pytest.mark.parametrize("name,engine,reads", [
    ("deepfm", "split", 2), ("deepfm", "fused", 1), ("dcn", "split", 2),
    ("wide", "split", 1)], ids=["deepfm-split", "deepfm-fused", "dcn-split",
                                "wide"])
def test_table_reads_per_step(name, engine, reads, monkeypatch):
    """The split engine reads two tables, the fused engine and the wide
    model one: each read is one row gather forward and one segment sum
    backward on the card."""
    calls = []
    real = emb_table.table_gather
    def counted(table, gids):
        calls.append(tuple(table.shape))
        return real(table, gids)

    monkeypatch.setattr(emb_table, "table_gather", counted)
    _, tm = _models(name, engine)
    ts, tx = TS.create_train_state(tm, 0, 1e-3, device="cpu")
    _, tb = _batch(32)
    TS.make_train_step(tm, tx)(ts, tb)
    assert len(calls) == reads
    if engine == "fused":
        fields = CriteoConfig(cat_vocabs=VOCABS).field_vocab_sizes
        assert calls[0] == (emb_table.pad_rows(sum(fields)),
                            SMALL["embedding_dim"] + 1)


def test_fused_engine_lookup_is_the_packed_table():
    """One packed table, original field order, the wide weight as its last
    column; the flat parameter is a view of what the gather reads."""
    cfg = EmbeddingConfig(field_vocab_sizes=(5, 7, 3), embedding_dim=2)
    eng = engines.make_engine(cfg, "fused")
    assert isinstance(eng, engines.FusedGatherEngine)
    params = eng.init(torch.Generator().manual_seed(0), "cpu")
    assert params["table_flat"].shape == (eng.v_pad * 3,) and eng.v_pad == 1024
    ids = torch.tensor([[4, 0, 2], [1, 6, 0]])
    emb, wide = eng.lookup(params, ids)
    table = params["table_flat"].view(eng.v_pad, 3)
    gids = ids + torch.tensor([0, 5, 12])
    assert torch.equal(emb, table[gids][..., :2])
    assert torch.equal(wide, table[gids][..., 2])
    parts = eng.lookup_parts(params, ids)
    assert parts.emb_parts is None and list(parts.field_order) == [0, 1, 2]
    with pytest.raises(ValueError, match="unknown embedding engine"):
        engines.make_engine(cfg, "sharded")


def test_cross_apply_matches_jax():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((9, 12)).astype(np.float32)
    params = [{"w": rng.standard_normal(12).astype(np.float32),
               "b": rng.standard_normal(12).astype(np.float32)}
              for _ in range(3)]
    ref = jinteractions.cross_apply(params, jnp.asarray(x0))
    got = interactions.cross_apply(convert.convert_params(params),
                                   torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-6)
    init = interactions.cross_init(torch.Generator().manual_seed(0), 624, 4,
                                   "cpu")
    assert [tuple(l["w"].shape) for l in init] == [(624,)] * 4
    # glorot_normal over [624]: std √(2 / 1248)
    assert abs(float(init[0]["b"].std()) - (2 / 1248) ** 0.5) < 0.01


# ---------------------------------------------------------------------------
# FTRL
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l1,l2", [(1.0, 1.0), (0.0, 0.0)])
def test_ftrl_update_matches_jax(l1, l2):
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal(400).astype(np.float32),
              "b": np.float32(0.2)}
    jtx, tx = joptim.ftrl(0.5, l1=l1, l2=l2), optim.ftrl(0.5, l1=l1, l2=l2)
    jp, js = params, jtx.init(params)
    tp = convert.convert_params(params)
    ts = tx.init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: (0.8 * rng.standard_normal(np.shape(a))
                                    ).astype(np.float32), params)
        jp, js = jtx.update(g, js, jp)
        same_p, same_s = tx.update(convert.convert_params(g), ts, tp)
        assert same_p is tp and same_s is ts       # updated in place
    _assert_trees_close(tp, jp, atol=1e-6, rtol=1e-5)
    _assert_trees_close(ts, js, atol=1e-6, rtol=1e-5)
    # with l1 = 1 both branches of the lazy weight are taken
    zero = np.asarray(jp["w"]) == 0
    assert zero.any() == (l1 > 0) and not zero.all()


def test_for_model_picks_the_declared_optimizer():
    ftrl = optim.for_model({"optimizer": "ftrl"}, 0.3)
    state = ftrl.init({"w": torch.zeros(3)})
    assert type(state).__name__ == "FtrlState"
    adam = optim.for_model({"emb_width": 5}, 0.3)
    assert type(adam.init({"w": torch.zeros(3)})).__name__ == "AdamState"


# ---------------------------------------------------------------------------
# servables and the command line
# ---------------------------------------------------------------------------

def _features(n, start_row=0):
    d = jcriteo.synthetic_criteo(n, JCriteo(cat_vocabs=VOCABS),
                                 start_row=start_row)
    return {"ids": d["ids"], "dense": d["dense"]}


@pytest.mark.parametrize("exporter", ["jax", "port"])
@pytest.mark.parametrize("name", ["dcn", "wide"])
def test_servables_cross_between_the_packages(name, exporter, tmp_path):
    jm, _ = _models(name)
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 4)
    kw = dict(SMALL, name=name)
    if exporter == "jax":
        jexport.export_servable(str(tmp_path), name, jparams, jstate,
                                JModel(**kw), JCriteo(cat_vocabs=VOCABS))
    else:
        params, state = convert.convert_params([jparams, jstate])
        export.export_servable(str(tmp_path), name, params, state,
                               ModelConfig(**kw),
                               CriteoConfig(cat_vocabs=VOCABS))
    feats = _features(23, start_row=40)
    ref = jexport.Servable(str(tmp_path), buckets=(32,)).predict(feats)
    sv = export.Servable(str(tmp_path), device="cpu")
    got = sv.predict(feats)
    assert got.shape == (23,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert float(np.std(ref)) > 1e-3
    sv.warmup()
    bad = dict(feats, ids=feats["ids"].copy())
    bad["ids"][2, 33] = 3000              # field 33's vocab is 3000
    with pytest.raises(ValueError):
        sv.predict(bad)


@pytest.mark.parametrize("name,over,lr", [
    ("dcn", {}, 0.01), ("wide", {}, 0.5),
    ("deepfm", {"emb_engine": "fused"}, 0.01)],
    ids=["dcn", "wide", "deepfm-fused"])
def test_train_cli_trains_the_zoo_on_the_cpu(name, over, lr, tmp_path):
    data_dir, model_dir = tmp_path / "data", tmp_path / "model"
    jcriteo.write_synthetic_shards(str(data_dir), 4000, 4,
                                   JCriteo(cat_vocabs=VOCABS))
    argv = ["train", "--device=cpu", f"--data_dir={data_dir}",
            f"--train.model_dir={model_dir}", f"--model.name={name}",
            "--model.embedding_dim=4", "--model.deep_layers=8,8",
            "--model.cross_layers=2",
            f"--criteo.cat_vocabs={','.join(map(str, VOCABS))}",
            "--train.batch_size=128", "--train.eval_every_steps=6",
            "--train.eval_steps=4", f"--train.learning_rate={lr}"] + [
                f"--model.{k}={v}" for k, v in over.items()]
    out = train_ctr.main(argv + ["--train.num_steps=12"])
    assert 0.0 <= out["auc"] <= 1.0 and np.isfinite(out["final_loss"])
    mgr = checkpoint.CheckpointManager(str(model_dir))
    assert mgr.latest_step() == 12
    # the JAX package restores the checkpoint into its own train state:
    # the same tree, FTRL's (z, n) state for wide
    jm, _ = _models(name, over.get("emb_engine", "split"))
    jts, _ = JTS.create_train_state(jm, seed=0, learning_rate=lr)
    jtree = jax.tree.map(np.asarray,
                         (jts.params, jts.model_state, jts.opt_state))
    back, step, _ = JCheckpoints(str(model_dir)).restore(jtree)
    assert step == 12 and type(back[2]).__name__ == (
        "FtrlState" if name == "wide" else "AdamState")
    # a second run resumes at step 12 and trains to 18
    out = train_ctr.main(argv + ["--train.num_steps=18"])
    assert mgr.latest_step() == 18 and np.isfinite(out["final_loss"])


# ---------------------------------------------------------------------------
# the repaired faults
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dcn_export(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dcn_export"))
    jm, _ = _models("dcn")
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 5)
    jexport.export_servable(d, "dcn", jparams, jstate,
                            JModel(**dict(SMALL, name="dcn")),
                            JCriteo(cat_vocabs=VOCABS))
    return d


@pytest.mark.parametrize("entry", ["Servable", "create_train_state"])
def test_entry_points_default_to_the_card(entry, dcn_export, monkeypatch):
    """Without a device argument both run on the card, and without a card
    they raise: neither falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "Servable":
            export.Servable(dcn_export)
        else:
            TS.create_train_state(_models("dcn")[1], 0, 1e-3)


def test_train_state_takes_the_optimizer_the_model_declares():
    def init(gen, device):
        return {"w": torch.ones(4, device=device)}, {}

    toy = api.Model("toy", init, lambda *a, **k: None,
                    meta={"optimizer": "ftrl"})
    ts, tx = TS.create_train_state(toy, 0, 0.5, device="cpu")
    assert type(ts.opt_state).__name__ == "FtrlState"
    tx.update({"w": torch.full((4,), 0.1)}, ts.opt_state, ts.params)
    ref = joptim.ftrl(0.5, l1=0.0, l2=0.0)
    want, _ = ref.update({"w": np.full(4, 0.1, np.float32)},
                         ref.init({"w": np.ones(4, np.float32)}),
                         {"w": np.ones(4, np.float32)})
    np.testing.assert_allclose(ts.params["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", ["deepfm", "dnn"])
def test_mlp_takes_emb_2d_when_the_engine_gives_no_parts(name, monkeypatch):
    """The split engine hands the MLP its parts; an engine without them
    (the fused one) hands it ``emb_2d``, with the same logits."""
    _, tm = _models(name)
    params, state = tm.init(torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(16)
    with torch.no_grad():
        want, _ = tm.apply(params, state, tb)
        real = engines.SplitEngine.lookup_parts
        monkeypatch.setattr(
            engines.SplitEngine, "lookup_parts",
            lambda self, *a, **k: real(self, *a, **k)._replace(
                emb_parts=None))
        got, _ = tm.apply(params, state, tb)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_profile_step_reads_its_models_and_needs_a_card(monkeypatch):
    assert profile_step.parse(["dcn", "deepfm:fused", "--batch=512"]) == (
        [("dcn", "split"), ("deepfm", "fused")], 512)
    specs, batch = profile_step.parse([])
    assert ("wide", "split") in specs and ("dnn", "fused") in specs
    assert batch == 16384
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        profile_step.main(["fm"])
