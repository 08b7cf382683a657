"""Serving in the port: servables exported by either package load in the
other and predict the same probabilities (tolerance 1e-5, float32 sums in
another order), the REST server answers every wire format, the checkpoint
format matches jax's, and nothing falls back from the card to the CPU."""

import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import criteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.serve import export as jexport
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.serve import client, export, server
from recsys_tpu_torch.tools import train_ctr
from test_torch_xdeepfm import randomize

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(name="xdeepfm", embedding_dim=4, cin_layers=(5, 3),
             deep_layers=(8, 8))
JCFG, JMCFG = JCriteo(cat_vocabs=VOCABS), JModel(**SMALL)
TCFG, TMCFG = CriteoConfig(cat_vocabs=VOCABS), ModelConfig(**SMALL)


def _randomized_jax_tree():
    """The JAX model's (params, state), every leaf seeded noise."""
    return randomize(jmake("xdeepfm", JCFG, JMCFG).init(jax.random.key(0)), 0)


def _features(n, start_row=0):
    d = criteo.synthetic_criteo(n, JCFG, start_row=start_row)
    return {"ids": d["ids"], "dense": d["dense"]}


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_export"))
    params, state = _randomized_jax_tree()
    jexport.export_servable(d, "xdeepfm", params, state, JMCFG, JCFG)
    return d


def test_jax_export_predicts_the_same_in_the_port(jax_export):
    feats = _features(21)
    ref = jexport.Servable(jax_export, buckets=(32,)).predict(feats)
    got = export.Servable(jax_export, device="cpu").predict(feats)
    assert got.shape == (21,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert float(np.std(ref)) > 1e-3


def test_port_export_predicts_the_same_in_jax(tmp_path):
    params, state = convert.convert_params(list(_randomized_jax_tree()))
    export.export_servable(str(tmp_path), "xdeepfm", params, state, TMCFG,
                           TCFG)
    feats = _features(19, start_row=50)
    got = export.Servable(str(tmp_path), device="cpu").predict(feats)
    ref = jexport.Servable(str(tmp_path), buckets=(32,)).predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_servable_rejects_bad_requests(jax_export):
    sv = export.Servable(jax_export, device="cpu")
    feats = _features(3)
    bad = dict(feats, ids=feats["ids"].copy())
    bad["ids"][1, 30] = 3000          # field 30's vocab is 3000
    with pytest.raises(ValueError):
        sv.predict(bad)
    with pytest.raises(ValueError):
        sv.predict(dict(feats, ids=feats["ids"][:, :38]))


def test_cuda_servable_raises_without_a_card(jax_export):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.Servable(jax_export, device="cuda")


@pytest.fixture
def rest(jax_export):
    sv = export.Servable(jax_export, device="cpu")
    srv, batcher = server.make_rest_server(sv, 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield sv, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    batcher.stop()
    t.join(5)
    assert not t.is_alive() and not batcher.thread.is_alive()


@pytest.mark.parametrize("fmt", ["json", "raw", "npz"])
def test_rest_server_answers_each_format(rest, fmt):
    sv, port = rest
    feats = _features(13, start_row=7)
    got = client.rest_send(port, client.prepare_body(feats, fmt), "xdeepfm")
    np.testing.assert_allclose(got, sv.predict(feats), atol=1e-6, rtol=0)


def test_rest_server_status_errors_and_concurrency(rest):
    sv, port = rest
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/models/xdeepfm", timeout=30) as r:
        assert b"AVAILABLE" in r.read()
    bad = _features(2)
    bad["ids"][0, 0] = -1
    with pytest.raises(urllib.error.HTTPError) as e:
        client.rest_predict(port, bad)
    assert e.value.code == 400
    # concurrent callers: each gets its own rows back, coalesced or not
    reqs = [_features(3 + i, start_row=100 * i) for i in range(8)]
    out = [None] * len(reqs)

    def call(i):
        out[i] = client.rest_send(port, client.prepare_body(reqs[i], "raw"))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    for f, o in zip(reqs, out):
        np.testing.assert_allclose(o, sv.predict(f), atol=1e-6, rtol=0)


def test_a_bad_request_fails_alone_in_a_coalesced_group(jax_export):
    """Behind a busy worker, a valid request and one with an id out of
    range are queued together: the bad one gets its 400 at once, on its own
    thread, and the valid one is answered with its probabilities."""
    sv = export.Servable(jax_export, device="cpu")
    plain_predict = sv.predict
    entered, release = threading.Event(), threading.Event()

    def busy_predict(features):          # the worker's first call waits
        entered.set()
        release.wait(30)
        return plain_predict(features)

    sv.predict = busy_predict
    srv, batcher = server.make_rest_server(sv, 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    good = _features(4, start_row=11)
    bad = _features(3, start_row=22)
    bad["ids"][1, 30] = 3000             # field 30's vocab is 3000
    out: dict = {}

    def call(name, feats):
        try:
            out[name] = client.rest_send(port, client.prepare_body(feats,
                                                                   "raw"))
        except urllib.error.HTTPError as e:
            out[name] = e.code

    batcher._inline.acquire()            # every request takes the queue
    try:
        threads = [threading.Thread(target=call, args=("first", good))]
        threads[0].start()
        assert entered.wait(30)          # the worker is busy with it
        for name, feats in (("good", good), ("bad", bad)):
            threads.append(threading.Thread(target=call, args=(name, feats)))
            threads[-1].start()
        for _ in range(300):             # both queued, or the bad one done
            if batcher.q.qsize() + ("bad" in out) >= 2:
                break
            threading.Event().wait(0.1)
        release.set()
        for t in threads:
            t.join(30)
    finally:
        release.set()
        batcher._inline.release()
        srv.shutdown()
        srv.server_close()
        batcher.stop()
    assert out["bad"] == 400
    np.testing.assert_allclose(out["good"], plain_predict(good), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(out["first"], plain_predict(good), atol=1e-6,
                               rtol=0)


def test_checkpoint_paths_follow_jax():
    tree = ({"tables": {"small": np.ones((2, 3), np.float32),
                        "big_wm": np.zeros((3, 4), np.float32),
                        "b": np.float32(0)},
             "cin": [{"w": np.ones(2), "b": np.ones(1)}] * 11},
            {"dnn": {"layers": [{"bn": {"mean": np.ones(2)}}, {}]}})
    ours = checkpoint.flatten(tree)
    theirs = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in ours] == [jax.tree_util.keystr(p) for p, _ in theirs]
    assert checkpoint.parse_path("[0]['cin'][10]['w']") == [0, "cin", 10, "w"]
    with pytest.raises(ValueError):
        checkpoint.parse_path("[0].cin")
    back = checkpoint.unflatten(ours)
    assert [p for p, _ in checkpoint.flatten(back)] == [p for p, _ in ours]
    # the empty BN-less layer has no leaves; fill_like restores it
    filled = tree_util.fill_like(tree, [a for _, a in ours])
    assert filled[1]["dnn"]["layers"][1] == {}


def test_checkpoint_manager_keeps_the_last_k(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep_max=2)
    for step in range(4):
        mgr.save(step, [{"w": np.full(3, step, np.float32)}])
    # published by rename: no step_N.tmp is left behind
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3"]
    tree, step, extra = mgr.restore()
    assert step == 3 and extra == {}
    np.testing.assert_array_equal(tree[0]["w"], np.full(3, 3, np.float32))
    assert checkpoint.CheckpointManager(str(tmp_path / "none")).restore() is None


@pytest.mark.parametrize("argv", [["train"], ["export", "--export_dir=x"],
                                  ["serve", "--model.name=dcn"]])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit):
        train_ctr.main(argv)
