"""DIN in the port against the JAX package, at a small config (item vocab
200, category vocab 10, embedding dim 8, attention MLP 8-4, top MLP 16-8,
batch 16, history padded to 8), on the same numpy inputs made from a seed.

- ``data.amazon``: identical arrays for a seed (exact: the same numpy code);
- ``din_attention`` forward and gradients, DIN logits (eval and train mode
  at dropout 0, from a converted JAX tree), the loss and every gradient
  against ``jax.value_and_grad`` (tolerance 1e-5 on values, 2e-6 absolute
  + 1e-4 relative on gradients: float32 sums of the same terms in another
  order);
- 3 Adam steps against JAX ``make_train_step`` (tolerance 2e-5: Adam's
  first steps move a weight by about lr·sign(g) = 1e-3, so a gradient that
  differs by rounding moves it by a few ulps of 1e-3 per step);
- the converter, servables exported by either package predicting the same
  in the other (1e-5), the REST server's 400 on an out-of-range id, and
  ``tools/train_din`` train → checkpoint → resume → eval → export →
  ``Servable`` predict on the CPU.
"""

import dataclasses
import os
import threading
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import amazon as jamazon
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.ops import interactions as jinteractions
from recsys_tpu.serve import export as jexport
from recsys_tpu.train import loop as jloop
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.config import ModelConfig
from recsys_tpu_torch.data import amazon
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import interactions, nn
from recsys_tpu_torch.serve import client, export, server
from recsys_tpu_torch.tools import train_ctr, train_din
from recsys_tpu_torch.train import fast, loop, optim
from recsys_tpu_torch.train import train_state as TS
from test_torch_train import GRAD_TOL, _assert_trees_close

ITEMS, CATES = 200, 10
SMALL = dict(name="din", embedding_dim=8, attention_layers=(8, 4),
             mlp_layers=(16, 8), use_bn=False, dropout=0.0)
B, P = 16, 8


def _models(**over):
    kw = dict(SMALL, **over)
    return (jmake("din", ITEMS, CATES, JModel(**kw)),
            make_model("din", ITEMS, CATES, ModelConfig(**kw)))


def _jax_tree(seed=1):
    """The JAX model's (params, state), every parameter seeded noise of
    scale 0.3, so that every weight matters."""
    jm, _ = _models()
    params, state = jm.init(jax.random.key(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.3 * rng.standard_normal(np.shape(a))
                                   ).astype(np.float32), params), state


def _batch(n=B, p=P, seed=0, label=True):
    """Numpy DIN features: histories of 1..p real ids, 0-padded."""
    rng = np.random.default_rng(seed)
    live = np.arange(p)[None, :] < rng.integers(1, p + 1, n)[:, None]
    d = {"i_id": rng.integers(1, ITEMS, n).astype(np.int32),
         "i_cate": rng.integers(1, CATES, n).astype(np.int32),
         "hist_iid": np.where(live, rng.integers(1, ITEMS, (n, p)), 0
                              ).astype(np.int32),
         "hist_cate": np.where(live, rng.integers(1, CATES, (n, p)), 0
                               ).astype(np.int32)}
    if label:
        d["label"] = (rng.random(n) < 0.5).astype(np.float32)
    return d


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["synthetic_din", "synthetic_din_hard"])
def test_amazon_arrays_identical_to_jax(make):
    kw = dict(n_users=300, item_vocab=ITEMS, cate_vocab=CATES, seed=5)
    t, j = getattr(amazon, make)(**kw), getattr(jamazon, make)(**kw)
    for f in dataclasses.fields(jamazon.DinDataset):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert t.hist_iid.shape[1] in amazon.DEFAULT_BUCKETS


def test_amazon_batches_and_npz_identical_to_jax(tmp_path):
    ds = amazon.synthetic_din(n_users=200, item_vocab=ITEMS,
                              cate_vocab=CATES, seed=2)
    ours = amazon.batches(ds, 32, seed=4)
    theirs = jamazon.batches(ds, 32, seed=4)
    for _ in range(20):                      # crosses an epoch boundary
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    path = amazon.save_din_npz(ds, str(tmp_path / "ds.npz"))
    back = jamazon.load_din_npz(path)
    np.testing.assert_array_equal(back.hist_cate, ds.hist_cate)
    assert (back.item_vocab, back.cate_vocab) == (ITEMS, CATES)
    for lengths in ([3, 9], [17], [200]):
        assert amazon.pad_to_bucket(np.asarray(lengths)) == \
            jamazon.pad_to_bucket(np.asarray(lengths))


# ---------------------------------------------------------------------------
# ops and model
# ---------------------------------------------------------------------------

def test_glorot_normal_is_an_untruncated_normal():
    x = nn.glorot_normal(torch.Generator().manual_seed(0), (4000, 60), "cpu")
    std = (2.0 / 4060) ** 0.5
    assert abs(float(x.std()) / std - 1) < 0.01
    assert abs(float(x.mean())) < 0.01 * std
    assert float(x.abs().max()) > 3 * std        # not cut at 2 std
    assert nn.glorot_normal(torch.Generator(), (3, 5), "meta").is_meta


def test_din_attention_matches_jax():
    rng = np.random.default_rng(3)
    jp = jax.tree.map(
        lambda a: (0.5 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jinteractions.din_attention_init(jax.random.key(0), 8, (8, 4)))
    hist = rng.standard_normal((B, P, 8)).astype(np.float32)
    query = rng.standard_normal((B, 8)).astype(np.float32)
    ids = _batch()["hist_iid"]
    wts = rng.standard_normal((B, 8)).astype(np.float32)

    def jloss(p, h, q):
        return jnp.sum(jinteractions.din_attention(p, h, ids, q) * wts)

    ref = jinteractions.din_attention(jp, hist, ids, query)
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jp, hist, query)

    tp = convert.convert_params(jp)
    live = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    h, q = (torch.from_numpy(a).requires_grad_() for a in (hist, query))
    out = interactions.din_attention(tp, h, torch.from_numpy(ids), q)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    loss = (out * torch.from_numpy(wts)).sum()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(loss, live + [h, q])
    want = jax.tree.leaves(jg[0]) + [jg[1], jg[2]]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    # a padded position gets no gradient
    assert not grads[-2].numpy()[ids == 0].any()


def test_port_init_has_the_jax_tree_layout():
    jm, tm = _models()
    j = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    t = convert.export_params(tm.init(torch.Generator().manual_seed(0), "cpu"))
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    tl = jax.tree_util.tree_flatten_with_path(t)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            jax.tree_util.keystr(p)
    assert not t[0]["item_bias"].any()
    assert set(t[0]) == {"item_bias", "item_emb", "cate_emb", "att_item",
                         "att_cate", "mlp", "final"}


def test_convert_round_trips_the_din_tree():
    """DIN's tree has no ``big_wm``: the converter maps it leaf for leaf,
    both ways, bitwise."""
    jparams, jstate = _jax_tree()
    tree = convert.convert_params((jparams, jstate))
    assert tuple(tree[0]["item_emb"].shape) == (ITEMS, 8)
    _assert_trees_close(tree, (jparams, jstate), atol=0, rtol=0)
    back = convert.export_params(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("train", [False, True])
def test_din_logits_match_jax(train):
    jm, tm = _models()
    jparams, jstate = _jax_tree()
    d = _batch()
    ref, _ = jax.jit(lambda p, s, b: jm.apply(
        p, s, b, train=train, rng=jax.random.key(1)))(jparams, jstate, d)
    with torch.no_grad():
        got, state = tm.apply(convert.convert_params(jparams),
                              convert.convert_params(jstate),
                              fast.stage_dataset(d, "cpu"), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert state == {"mlp": {"layers": [{}, {}]}}
    assert float(np.std(np.asarray(ref))) > 0.1


def test_padding_the_history_leaves_the_answer_bitwise_unchanged():
    _, tm = _models()
    params, state = convert.convert_params(list(_jax_tree()))
    d16 = _batch(p=16, label=False)
    d32 = dict(d16)
    for k in ("hist_iid", "hist_cate"):
        d32[k] = np.pad(d16[k], ((0, 0), (0, 16)))
    with torch.no_grad():
        a, _ = tm.apply(params, state, fast.stage_dataset(d16, "cpu"))
        b, _ = tm.apply(params, state, fast.stage_dataset(d32, "cpu"))
    assert torch.equal(a, b)


def test_din_loss_and_gradients_match_jax():
    jm, tm = _models()
    jparams, jstate = _jax_tree()
    d = _batch(n=64, seed=4)

    def jloss(p):
        logits, _ = jm.apply(p, jstate, d, train=True, rng=jax.random.key(1))
        return JTS.sigmoid_ce(logits, d["label"])

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    loss, _, grads = TS.loss_and_grads(tm, convert.convert_params(jparams),
                                       convert.convert_params(jstate),
                                       fast.stage_dataset(d, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    # the four table reads carry gradient into both tables, on the rows
    # the batch touched and nowhere else
    for name, keys in (("item_emb", ("i_id", "hist_iid")),
                       ("cate_emb", ("i_cate", "hist_cate"))):
        touched = np.zeros(len(grads[name]), bool)
        for k in keys:
            touched[d[k].ravel()] = True
        rows = grads[name].abs().sum(dim=1).numpy()
        assert (rows[touched & (np.arange(len(rows)) > 0)] > 0).all(), name
        assert not rows[~touched].any(), name


def test_item_bias_is_read_through_the_table_gather(monkeypatch):
    """A DIN train step reads all five tables through `table_gather`'s
    autograd function: the item bias as its ``[V, 1]`` view, so that on the
    card its forward is the row gather and its backward the segment sum (a
    plain ``index_select`` had an atomic ``index_add_`` backward). Its
    gradient still matches the JAX model's (`jnp.take`)."""
    from recsys_tpu_torch.embeddings import table

    jm, tm = _models()
    jparams, jstate = _jax_tree()
    d = _batch(n=64, seed=6)
    shapes = []
    apply = table._TableGather.apply

    def counted(t, flat_ids):
        shapes.append(tuple(t.shape))
        return apply(t, flat_ids)

    monkeypatch.setattr(table._TableGather, "apply", counted)
    _, _, grads = TS.loss_and_grads(tm, convert.convert_params(jparams),
                                    convert.convert_params(jstate),
                                    fast.stage_dataset(d, "cpu"))
    assert sorted(shapes) == sorted([(ITEMS, 8)] * 2 + [(CATES, 8)] * 2
                                    + [(ITEMS, 1)])

    def jloss(p):
        logits, _ = jm.apply(p, jstate, d, train=True, rng=jax.random.key(1))
        return JTS.sigmoid_ce(logits, d["label"])

    jgrads = jax.jit(jax.grad(jloss))(jparams)
    np.testing.assert_allclose(grads["item_bias"].numpy(),
                               np.asarray(jgrads["item_bias"]), **GRAD_TOL)
    touched = np.zeros(ITEMS, bool)
    touched[d["i_id"]] = True
    assert (grads["item_bias"].numpy()[touched] != 0).all()
    assert not grads["item_bias"].numpy()[~touched].any()


def test_three_adam_steps_match_jax():
    jm, tm = _models()
    jts, jtx = JTS.create_train_state(jm, seed=3, learning_rate=1e-3)
    port_ts = convert.convert_train_state(jax.tree.map(
        np.asarray, jts._replace(rng=jax.random.key_data(jts.rng))))
    step = TS.make_train_step(tm, optim.adam(1e-3))
    jstep = JTS.make_train_step(jm, jtx)
    for i in range(3):
        d = _batch(n=32, seed=10 + i)
        jts, jloss = jstep(jts, {k: jnp.asarray(v) for k, v in d.items()})
        port_ts, loss = step(port_ts, fast.stage_dataset(d, "cpu"))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(port_ts.step) == int(jts.step) == 3
    _assert_trees_close(port_ts.params, jts.params, atol=2e-5, rtol=0)
    _assert_trees_close(port_ts.opt_state, jts.opt_state, atol=1e-6,
                        rtol=1e-3)


def test_evaluate_matches_jax():
    jm, tm = _models()
    jparams, jstate = _jax_tree()
    batches = [_batch(seed=20 + i) for i in range(4)]
    want = jloop.evaluate(jm, jparams, jstate, iter(batches), max_steps=3)
    got = loop.evaluate(tm, convert.convert_params(jparams),
                        convert.convert_params(jstate), iter(batches),
                        device="cpu", max_steps=3)
    assert got["count"] == want["count"] == 3 * B
    for k in ("auc", "accuracy", "logloss"):
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), k


def test_sample_features_match_jax():
    jm, tm = _models()
    a, b = tm.meta["sample_features"](5), jm.meta["sample_features"](5)
    assert a.keys() == b.keys() and a["hist_iid"].shape == (5, 32)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _export_jax(d):
    jparams, jstate = _jax_tree()
    jexport.export_servable(d, "din", jparams, jstate, JModel(**SMALL),
                            criteo_cfg=None,
                            factory_kwargs={"item_vocab": ITEMS,
                                            "cate_vocab": CATES})
    return d


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    return _export_jax(str(tmp_path_factory.mktemp("din_jax_export")))


def test_jax_export_predicts_the_same_in_the_port(jax_export):
    feats = _batch(n=13, label=False)
    ref = jexport.Servable(jax_export, buckets=(16,)).predict(feats)
    sv = export.Servable(jax_export, device="cpu")
    got = sv.predict(feats)
    assert got.shape == (13,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert float(np.std(ref)) > 1e-2
    sv.warmup()                                  # sample_features request


def test_port_export_predicts_the_same_in_jax(tmp_path):
    params, state = convert.convert_params(list(_jax_tree(seed=7)))
    export.export_servable(str(tmp_path), "din", params, state,
                           ModelConfig(**SMALL),
                           factory_kwargs={"item_vocab": ITEMS,
                                           "cate_vocab": CATES})
    feats = _batch(n=11, seed=3, label=False)
    got = export.Servable(str(tmp_path), device="cpu").predict(feats)
    ref = jexport.Servable(str(tmp_path), buckets=(16,)).predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bad", [
    "item_high", "cate_high", "negative", "float", "missing", "hist_1d",
    "p0", "b_mismatch", "p_mismatch"])
def test_servable_rejects_bad_din_requests(jax_export, bad):
    sv = export.Servable(jax_export, device="cpu")
    f = _batch(n=4, label=False)
    if bad == "item_high":
        f["hist_iid"][2, 1] = ITEMS
    elif bad == "cate_high":
        f["i_cate"][0] = CATES
    elif bad == "negative":
        f["hist_cate"][1, 0] = -1
    elif bad == "float":
        f["i_id"] = f["i_id"].astype(np.float32)
    elif bad == "missing":
        del f["hist_cate"]
    elif bad == "hist_1d":
        f["hist_iid"] = f["hist_iid"][:, 0]
    elif bad == "p0":
        f["hist_iid"], f["hist_cate"] = f["hist_iid"][:, :0], \
            f["hist_cate"][:, :0]
    elif bad == "b_mismatch":
        f["i_cate"] = f["i_cate"][:3]
    else:
        f["hist_cate"] = f["hist_cate"][:, :5]
    with pytest.raises(ValueError):
        sv.predict(f)


def test_other_non_criteo_servables_are_not_ported(tmp_path):
    d = _export_jax(str(tmp_path))
    meta_path = os.path.join(d, "servable.json")
    with open(meta_path) as f:
        text = f.read()
    with open(meta_path, "w") as f:
        f.write(text.replace('"model_name": "din"', '"model_name": "vae_cf"'))
    with pytest.raises(NotImplementedError):
        export.Servable(d, device="cpu")


def test_rest_server_answers_400_on_an_out_of_range_id(jax_export):
    sv = export.Servable(jax_export, device="cpu")
    srv, batcher = server.make_rest_server(sv, 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    try:
        good = _batch(n=5, label=False)
        for fmt in ("json", "npz", "raw"):
            got = client.rest_send(port, client.prepare_body(good, fmt))
            np.testing.assert_allclose(got, sv.predict(good), atol=1e-6,
                                       rtol=0)
        bad = dict(good, hist_iid=good["hist_iid"].copy())
        bad["hist_iid"][3, 2] = ITEMS + 5
        with pytest.raises(urllib.error.HTTPError) as e:
            client.rest_send(port, client.prepare_body(bad, "raw"))
        assert e.value.code == 400
        # the server keeps answering
        got = client.rest_predict(port, good)
        np.testing.assert_allclose(got, sv.predict(good), atol=1e-6, rtol=0)
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        t.join(5)
    assert not t.is_alive() and not batcher.thread.is_alive()


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def test_train_din_cli_round_trip(tmp_path, monkeypatch):
    """The port's counterpart of tests/test_din_train.py's CLI round trip,
    on the CPU: train → checkpoint → resume → eval → predict → export →
    Servable predict."""
    monkeypatch.chdir(tmp_path)
    common = [
        "--device=cpu", "--synthetic_users=600", "--item_vocab=200",
        "--cate_vocab=10", "--model.embedding_dim=8",
        "--model.attention_layers=8,4", "--model.mlp_layers=16,8",
        "--train.batch_size=128", "--train.eval_steps=4",
        f"--train.model_dir={tmp_path / 'm'}",
    ]
    train = ["train", "--train.eval_every_steps=15",
             "--train.log_every_steps=10", "--train.learning_rate=0.005"]
    metrics = train_din.main(train + ["--train.num_steps=30"] + common)
    assert np.isfinite(metrics["final_loss"])
    assert np.isfinite(metrics["first_loss"])
    assert 0.0 <= metrics["auc"] <= 1.0
    assert sorted(os.listdir(tmp_path / "m")) == ["step_15", "step_30"]
    # a second run resumes at step 30 and trains to 40
    metrics = train_din.main(train + ["--train.num_steps=40"] + common)
    assert os.path.exists(tmp_path / "m" / "step_40")
    assert np.isfinite(metrics["final_loss"])

    m_eval = train_din.main(["eval"] + common)
    assert 0.0 <= m_eval["auc"] <= 1.0 and m_eval["count"] > 0
    probs = train_din.main(["predict"] + common)["probs"]
    assert np.all((probs >= 0) & (probs <= 1)) and len(probs) > 0

    out = train_din.main(["export", f"--export_dir={tmp_path / 'exp'}"]
                         + common)
    sv = export.Servable(out["export_dir"], device="cpu")
    feats = sv._sample_features(5)
    got = sv.predict(feats)
    assert got.shape == (5,) and np.all((got >= 0) & (got <= 1))
    # the JAX package loads it too
    ref = jexport.Servable(out["export_dir"], buckets=(8,)).predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("argv", [
    ["train", "--device=tpu"],
    ["train", "--device=cpu", "--bogus=1"],
    ["train", "--device=cpu", "--model.nope=1"],
    ["fit", "--device=cpu"],
])
def test_train_din_cli_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        train_din.main(argv)


def test_train_ctr_sends_din_to_its_own_command():
    with pytest.raises(SystemExit, match="train_din"):
        train_ctr.main(["train", "--device=cpu", "--model.name=din"])
