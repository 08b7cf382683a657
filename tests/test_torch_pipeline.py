"""The port's streaming input pipeline and host-fed step against the JAX
package, on the CPU, at small sizes (vocabs ``(50,)*20 + (3000,)*6``,
embedding dim 4, towers 8-8), on the same inputs made from a seed:

- `loader.ShardSource`: the same batches, bit for bit, as the JAX
  ``ShardSource`` over two epochs, shuffled or not, seeds 0 and 1, shards of
  unequal lengths whose rows carry across shard boundaries, ``keys`` and the
  shard cache on and off;
- `native` and the TSV preprocessor: `parse_criteo_bytes` against the JAX
  package's pure-Python ``parse_tsv_chunk`` and ``hash_cat`` (exact), a
  partial last line left unconsumed, `gather_rows` on both paths (exact,
  and IndexError out of range on both), `preprocess_tsv` native and in
  Python against the JAX package's (every shard array exact, with
  ``bucketize_log`` both ways);
- `demo`: the same arrays for a seed;
- `loader.device_prefetch` on the CPU: the same batches in order, an
  exception in the source or in the transfer raised in the consumer within
  a few seconds, no thread left alive after an early stop;
- `fast.make_fed_train_step`: eager, bitwise the parent's
  `train_state.make_train_step` loop (DeepFM at dropout 0.5, DIN); graphed
  with the graph stood in for, bitwise the eager step, one capture per
  batch layout (a short batch and a new history length P capture anew);
- `loop.train_and_evaluate` over `ShardSource` against the JAX loop over
  the JAX ``ShardSource`` from one initial state, DeepFM at dropout 0, 6
  steps (loss rtol 1e-5, parameters atol 2e-5, as in
  tests/test_torch_train.py; the eval's count exactly);
- ``train_ctr`` on the CPU: ``--streaming`` and a training set over
  ``--hbm_data_budget`` train and resume; ``eval``, ``predict`` and
  ``export`` give the JAX command's output on one checkpoint (AUC and count
  exactly, the mean probability within 1e-5, the exported arrays exactly).

None of these tests starts the JAX package's g++ build of its native
library: the fixture ``no_jax_native`` makes its ``get_lib`` return None
(that build writes straight to its final path, and workers that start it
at once can load a partial library). The port's own build publishes its
library with one rename, so workers may build it at once.
"""

import concurrent.futures
import itertools
import json
import threading

import numpy as np
import pytest
import torch

from recsys_tpu.core.checkpoint import CheckpointManager as JCheckpoints
from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.core.config import TrainConfig as JTrain
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.data import demo as jdemo
from recsys_tpu.data import loader as jloader
from recsys_tpu.data import native as jnative
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.tools import train_ctr as jtrain_ctr
from recsys_tpu.train import loop as jloop
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch.core import checkpoint
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig, TrainConfig
from recsys_tpu_torch.data import amazon, criteo, demo, loader, native
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import train_ctr
from recsys_tpu_torch.train import fast, loop
from recsys_tpu_torch.train import train_state as TS
from test_torch_graph_step import stand_in_graphs  # noqa: F401 (fixture)

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(embedding_dim=4, deep_layers=(8, 8), use_bn=True)
TIMEOUT_S = 5.0


@pytest.fixture
def no_jax_native(monkeypatch):
    monkeypatch.setattr(jnative, "get_lib", lambda: None)


def _shards(tmp_path, rows=(100, 70, 130)):
    """Synthetic shards of unequal lengths (rows carry across them)."""
    paths = []
    for i, n in enumerate(rows):
        d = jcriteo.synthetic_criteo(n, JCriteo(cat_vocabs=VOCABS),
                                     start_row=1000 * i)
        paths.append(str(tmp_path / f"part-r-{i:05d}.npz"))
        np.savez(paths[-1], **d)
    return paths


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------------------------------- ShardSource

@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 1), (False, 0)])
@pytest.mark.parametrize("keys,cache", [(None, True), (("ids", "label"),
                                                       False)])
def test_shard_source_is_the_jax_shard_source(tmp_path, no_jax_native,
                                              shuffle, seed, keys, cache):
    paths = _shards(tmp_path)
    kw = dict(shuffle=shuffle, seed=seed, num_epochs=2, keys=keys,
              cache=cache)
    got = list(loader.ShardSource(paths, 48, **kw))
    want = list(jloader.ShardSource(paths, 48, **kw))
    _assert_batches_equal(got, want)
    assert len(got) == 2 * (300 // 48)          # carries, then the remainder
    assert set(got[0]) == set(keys or ("ids", "dense", "label"))


# -------------------------------------------------- native and preprocessing

_ODD_ROWS = [
    "1\t-3\t" + "\t".join(["2"] * 12) + "\t" + "\t".join(["deadbeef"] * 26),
    "0\t\t5\t\t7",                               # trailing fields missing
    "1\t" + "\t" * 12 + "\t" + "\t".join([""] * 25 + ["x"]),
]


def _tsv_lines(tmp_path, rows=300):
    path = tmp_path / "day.tsv"
    criteo.write_synthetic_tsv(str(path), rows, seed=4)
    with open(path) as f:
        return [line for line in f] + [r + "\n" for r in _ODD_ROWS]


def test_native_parse_is_the_jax_python_parse(tmp_path):
    if not native.available():
        pytest.skip("no g++ to build the host library")
    lines = _tsv_lines(tmp_path)
    cfg = JCriteo()
    labels, cont, cat, consumed = native.parse_criteo_bytes(
        "".join(lines).encode(), cfg.cat_vocabs)
    want_labels, want_cont, want_cat = jcriteo.parse_tsv_chunk(lines)
    assert consumed == len("".join(lines).encode())
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(cont, want_cont)     # NaN where missing
    np.testing.assert_array_equal(cat, jcriteo.hash_cat(want_cat, cfg))
    # the port's pure-Python path is the JAX package's
    for g, w in zip(criteo.parse_tsv_chunk(lines),
                    (want_labels, want_cont, want_cat)):
        np.testing.assert_array_equal(g, w)


def test_native_parse_leaves_a_partial_line_unconsumed():
    if not native.available():
        pytest.skip("no g++ to build the host library")
    row = _ODD_ROWS[0] + "\n"
    blob = (row + row[:len(row) // 2]).encode()
    labels, _, _, consumed = native.parse_criteo_bytes(blob,
                                                       JCriteo().cat_vocabs)
    assert len(labels) == 1 and consumed == len(row.encode())


@pytest.mark.parametrize("path", ["native", "python"])
def test_gather_rows_on_both_paths(monkeypatch, path):
    if path == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("no g++ to build the host library")
    rng = np.random.default_rng(0)
    for src in (rng.integers(0, 9, (70_000, 39)).astype(np.int32),
                rng.random(70_000).astype(np.float32),
                rng.random((5, 3, 2))):
        idx = rng.permutation(len(src))
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
        np.testing.assert_array_equal(native.gather_rows(src, idx[:0]),
                                      src[:0])
        for bad in (-1, len(src)):
            with pytest.raises(IndexError):
                native.gather_rows(src, np.array([0, bad]))


@pytest.mark.parametrize("bucketize_log", [False, True])
@pytest.mark.parametrize("path", ["native", "python"])
def test_preprocess_tsv_is_the_jax_preprocessor(tmp_path, monkeypatch,
                                                no_jax_native, path,
                                                bucketize_log):
    if path == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif not native.available():
        pytest.skip("no g++ to build the host library")
    lines = _tsv_lines(tmp_path)
    with open(tmp_path / "all.tsv", "w") as f:
        f.writelines(lines)
    kw = dict(rows_per_shard=128, bucketize_log=bucketize_log)
    got = criteo.preprocess_tsv(str(tmp_path / "all.tsv"),
                                str(tmp_path / "port"), **kw)
    want = jcriteo.preprocess_tsv(str(tmp_path / "all.tsv"),
                                  str(tmp_path / "jax"), **kw)
    assert [p.replace("port", "jax") for p in got] == want
    assert len(got) == 3                       # 303 rows: 128, 128, 47
    for g, w in zip(got, want):
        with np.load(g) as zg, np.load(w) as zw:
            assert zg.files == zw.files == ["ids", "dense", "label"]
            for k in zg.files:
                np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
    np.testing.assert_array_equal(np.load(tmp_path / "port/cont_means.npy"),
                                  np.load(tmp_path / "jax/cont_means.npy"))


@pytest.mark.parametrize("max_rows,given_means", [(200, False), (None, True),
                                                  (150, True)])
def test_preprocess_tsv_with_max_rows_and_given_means_is_jax(
        tmp_path, no_jax_native, max_rows, given_means):
    """``max_rows`` (the first lines only, the means of those lines) and
    ``means`` (an eval set imputed with the training set's means), as the
    JAX preprocessor takes them."""
    lines = _tsv_lines(tmp_path)
    with open(tmp_path / "all.tsv", "w") as f:
        f.writelines(lines)
    means = (np.arange(1, 14, dtype=np.float32) * 2.5 if given_means
             else None)
    kw = dict(rows_per_shard=128, max_rows=max_rows, means=means)
    got = criteo.preprocess_tsv(str(tmp_path / "all.tsv"),
                                str(tmp_path / "port"), **kw)
    want = jcriteo.preprocess_tsv(str(tmp_path / "all.tsv"),
                                  str(tmp_path / "jax"), **kw)
    assert [p.replace("port", "jax") for p in got] == want
    rows = 0
    for g, w in zip(got, want):
        with np.load(g) as zg, np.load(w) as zw:
            for k in zw.files:
                np.testing.assert_array_equal(zg[k], zw[k], err_msg=k)
            rows += len(zg["label"])
    assert rows == (max_rows or len(lines))
    saved = np.load(tmp_path / "port/cont_means.npy")
    np.testing.assert_array_equal(saved,
                                  np.load(tmp_path / "jax/cont_means.npy"))
    if given_means:
        np.testing.assert_array_equal(saved, means)
    else:
        np.testing.assert_array_equal(
            saved, criteo.compute_means(str(tmp_path / "all.tsv"), max_rows))
        assert not np.array_equal(
            saved, criteo.compute_means(str(tmp_path / "all.tsv")))


# ----------------------------------------------------------------------- demo

def test_demo_is_the_jax_demo():
    for seed in (0, 3):
        _assert_batches_equal([demo.synthetic_demo(500, seed=seed)],
                              [jdemo.synthetic_demo(500, seed=seed)])
    u = np.array([1, 2 ** 40, 7], np.int64)
    i = np.array([5, 6, 2 ** 33], np.int64)
    got = demo.hash_demo_batch(u, i, None, demo.demo_schema(10, 20))
    want = jdemo.hash_demo_batch(u, i, None, jdemo.demo_schema(10, 20))
    _assert_batches_equal([got], [want])
    assert "label" not in got
    assert demo.demo_schema().field_vocab_sizes == \
        jdemo.demo_schema().field_vocab_sizes


# ------------------------------------------------------------ device_prefetch

def _consume(it, limit=None):
    """Drain ``it`` in a worker so a hang fails the test after TIMEOUT_S
    instead of stopping the suite."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(lambda: list(itertools.islice(it, limit))
                           ).result(timeout=TIMEOUT_S)


def test_device_prefetch_yields_the_host_batches_in_order(tmp_path,
                                                          no_jax_native):
    paths = _shards(tmp_path)
    src = loader.ShardSource(paths, 32, seed=3, num_epochs=2)
    got = _consume(loader.device_prefetch(iter(src), "cpu"))
    want = list(src)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["ids"].dtype == torch.int64        # the gathers' index type
        assert g["dense"].dtype == torch.float32
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def _batches(n):
    for i in range(n):
        yield {"ids": np.full((4, 3), i, np.int32),
               "label": np.zeros(4, np.float32)}


def test_device_prefetch_raises_a_source_error_in_the_consumer():
    def source():
        yield from _batches(2)
        raise KeyError("the source failed")

    with pytest.raises(KeyError, match="the source failed"):
        _consume(loader.device_prefetch(source(), "cpu"))


def test_device_prefetch_raises_a_transfer_error_in_the_consumer():
    def source():
        yield from _batches(2)
        yield {"ids": np.array([object()])}        # torch cannot take it
        yield from _batches(100)

    it = loader.device_prefetch(source(), "cpu")
    with pytest.raises(TypeError):
        _consume(it)


def test_device_prefetch_stops_its_threads_on_an_early_stop():
    def forever():
        for i in itertools.count():
            yield {"x": np.full(2, i, np.int32)}

    before = set(threading.enumerate())
    it = loader.device_prefetch(forever(), "cpu", depth=2)
    assert int(next(it)["x"][0]) == 0
    workers = set(threading.enumerate()) - before
    assert {t.name for t in workers} == {"device_prefetch-generate",
                                         "device_prefetch-transfer"}
    assert [int(next(it)["x"][0]) for _ in range(3)] == [1, 2, 3]
    it.close()                                       # the consumer stops
    for t in workers:
        t.join(timeout=TIMEOUT_S)
        assert not t.is_alive(), t.name


# ------------------------------------------------------------ the fed step

def _deepfm(dropout):
    return make_model("deepfm", CriteoConfig(cat_vocabs=VOCABS),
                      ModelConfig(name="deepfm", dropout=dropout, **SMALL))


def _din():
    return make_model("din", 200, 10, ModelConfig(
        name="din", embedding_dim=8, attention_layers=(8, 4),
        mlp_layers=(16, 8), use_bn=False, dropout=0.1))


def _criteo_batches(sizes):
    return [fast.stage_dataset(jcriteo.synthetic_criteo(
        b, JCriteo(cat_vocabs=VOCABS), start_row=100 * i), "cpu")
        for i, b in enumerate(sizes)]


def _din_batches(ps, b=16):
    out = []
    for i, p in enumerate(ps):
        ds = amazon.synthetic_din(n_users=60, item_vocab=200, cate_vocab=10,
                                  seed=i)
        data = {"i_id": ds.i_id, "i_cate": ds.i_cate,
                "hist_iid": ds.hist_iid, "hist_cate": ds.hist_cate,
                "label": ds.label}
        # the history cut or zero-padded to P columns
        for k in ("hist_iid", "hist_cate"):
            h = np.zeros((len(ds.label), p), np.int32)
            w = min(p, data[k].shape[1])
            h[:, :w] = data[k][:, :w]
            data[k] = h
        out.append(fast.stage_dataset({k: v[:b] for k, v in data.items()},
                                      "cpu"))
    return out


def _leaves(ts):
    return tree_util.leaves((ts.params, ts.model_state, ts.opt_state))


def _fed_run(model, batches, graphed):
    ts, tx = TS.create_train_state(model, 5, 1e-2, "cpu")
    step = fast.make_fed_train_step(model, tx, graphed=graphed)
    losses = [step(ts, batch, 7 + i) for i, batch in enumerate(batches)]
    return ts, losses


@pytest.mark.parametrize("name", ["deepfm", "din"])
def test_fed_step_is_the_train_step_loop_bitwise(name):
    model = _deepfm(0.5) if name == "deepfm" else _din()
    batches = (_criteo_batches([64] * 3) if name == "deepfm"
               else _din_batches([8] * 3))
    ts, losses = _fed_run(model, batches, graphed=False)
    # the parent's host-fed loop: reseed, then the functional step
    ts_ref, tx = TS.create_train_state(model, 5, 1e-2, "cpu")
    step = TS.make_train_step(model, tx)
    for i, batch in enumerate(batches):
        TS.reseed(ts_ref, 7 + i)
        ts_ref, loss = step(ts_ref, batch)
        assert torch.equal(losses[i], loss)
    for a, b in zip(_leaves(ts), _leaves(ts_ref), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["deepfm", "din"])
def test_graphed_fed_step_captures_once_per_batch_layout(stand_in_graphs,
                                                         name):
    model = _deepfm(0.5) if name == "deepfm" else _din()
    # DeepFM: two full batches, then a short one; DIN: two batches at
    # P = 8, then one at P = 12
    batches = (_criteo_batches([64, 64, 40, 40]) if name == "deepfm"
               else _din_batches([8, 8, 12, 12]))
    ts_e, l_e = _fed_run(model, batches, graphed=False)
    assert stand_in_graphs == []
    ts_g, l_g = _fed_run(model, batches, graphed=True)
    assert stand_in_graphs == ["make_fed_train_step"] * 2
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    for a, b in zip(_leaves(ts_e), _leaves(ts_g), strict=True):
        assert torch.equal(a, b)
    # the returned loss is the step's own, not the graph's static scalar
    assert len({float(x) for x in l_g}) == len(l_g)


# --------------------------------------------------------- the slice as a whole

def test_streaming_loop_matches_the_jax_loop(tmp_path, no_jax_native):
    """Port ``loop.train_and_evaluate`` over `ShardSource` against the JAX
    loop over the JAX ``ShardSource``: both resume one JAX initial state
    (a step-0 checkpoint), train 6 steps and evaluate."""
    paths = _shards(tmp_path, rows=(300, 260, 200))
    kw = dict(SMALL, name="deepfm", dropout=0.0)
    jm = jmake("deepfm", JCriteo(cat_vocabs=VOCABS), JModel(**kw))
    tm = make_model("deepfm", CriteoConfig(cat_vocabs=VOCABS),
                    ModelConfig(**kw))
    jts, _ = JTS.create_train_state(jm, seed=4, learning_rate=1e-2)
    train_kw = dict(batch_size=64, learning_rate=1e-2, eval_every_steps=6,
                    eval_steps=2, log_every_steps=3, seed=4)
    out = {}
    for who in ("jax", "port"):
        model_dir = str(tmp_path / who)
        JCheckpoints(model_dir).save(0, (jts.params, jts.model_state,
                                         jts.opt_state))
        if who == "jax":
            out[who] = jloop.train_and_evaluate(
                jm, iter(jloader.ShardSource(paths[:2], 64, seed=4)),
                lambda: jloader.ShardSource(paths[2:], 64, shuffle=False,
                                            num_epochs=1),
                JTrain(model_dir=model_dir, **train_kw), num_steps=6)
        else:
            out[who] = loop.train_and_evaluate(
                tm, iter(loader.ShardSource(paths[:2], 64, seed=4)),
                lambda: loader.ShardSource(paths[2:], 64, shuffle=False,
                                           num_epochs=1),
                TrainConfig(model_dir=model_dir, **train_kw), num_steps=6,
                device="cpu")
    np.testing.assert_allclose(out["port"]["final_loss"],
                               out["jax"]["final_loss"], rtol=1e-5)
    assert out["port"]["count"] == out["jax"]["count"] == 2 * 64
    np.testing.assert_allclose(out["port"]["logloss"], out["jax"]["logloss"],
                               rtol=1e-5)
    got = _checkpoint_leaves(tmp_path / "port" / "step_6")
    want = _checkpoint_leaves(tmp_path / "jax" / "step_6")
    assert got.keys() == want.keys()
    for path in got:       # parameters 2e-5; BN and Adam state 1e-5 + 1e-5
        tol = (dict(atol=2e-5, rtol=0) if path.startswith("[0]")
               else dict(atol=1e-5, rtol=1e-5))
        np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                   **tol)


def test_the_loop_draws_one_batch_per_step(tmp_path):
    """The loop's prefetch threads read ahead, but the loop hands them only
    its steps' batches: a caller that shares the iterator with a later
    call loses none."""
    host = [jcriteo.synthetic_criteo(32, JCriteo(cat_vocabs=VOCABS),
                                     start_row=100 * i) for i in range(12)]
    it = iter(host)
    cfg = TrainConfig(model_dir=str(tmp_path), batch_size=32,
                      eval_every_steps=3, eval_steps=1, log_every_steps=3)
    out = loop.train_and_evaluate(_deepfm(0.0), it, lambda: host[:1], cfg,
                                  num_steps=3, device="cpu", resume=False)
    assert out["count"] == 32
    assert next(it) is host[3]


def _checkpoint_leaves(step_dir) -> dict:
    """{leaf path: array} of one checkpoint directory (either package's:
    they share the layout)."""
    with open(step_dir / "meta.json") as f:
        manifest = json.load(f)["manifest"]
    with np.load(step_dir / "arrays.npz") as z:
        return {path: z[key] for path, key in manifest}


# ------------------------------------------------------------------ train_ctr

def _cli_flags(data_dir, model_dir):
    return ["--model.name=deepfm", "--device=cpu", f"--data_dir={data_dir}",
            f"--train.model_dir={model_dir}", "--model.embedding_dim=4",
            "--model.deep_layers=8,8",
            f"--criteo.cat_vocabs={','.join(map(str, VOCABS))}",
            "--train.batch_size=128", "--train.eval_every_steps=6",
            "--train.eval_steps=4", "--train.learning_rate=0.01"]


@pytest.mark.parametrize("flag", ["--streaming", "--hbm_data_budget=1"])
def test_train_cli_streams_and_resumes(tmp_path, flag):
    data_dir, model_dir = tmp_path / "data", tmp_path / "model"
    jcriteo.write_synthetic_shards(str(data_dir), 4000, 4,
                                   JCriteo(cat_vocabs=VOCABS))
    argv = ["train", flag] + _cli_flags(data_dir, model_dir)
    out = train_ctr.main(argv + ["--train.num_steps=12"])
    assert 0.0 <= out["auc"] <= 1.0 and out["count"] == 4 * 128
    mgr = checkpoint.CheckpointManager(str(model_dir))
    assert mgr.latest_step() == 12
    out = train_ctr.main(argv + ["--train.num_steps=18"])
    assert mgr.latest_step() == 18 and np.isfinite(out["auc"])


@pytest.fixture(scope="module")
def trained_checkpoint(tmp_path_factory):
    """Shards and a 12-step port checkpoint of small DeepFM."""
    tmp = tmp_path_factory.mktemp("cli")
    data_dir, model_dir = tmp / "data", tmp / "model"
    jcriteo.write_synthetic_shards(str(data_dir), 4000, 4,
                                   JCriteo(cat_vocabs=VOCABS))
    train_ctr.main(["train", "--train.num_steps=12"]
                   + _cli_flags(data_dir, model_dir))
    return tmp, _cli_flags(data_dir, model_dir)


@pytest.mark.parametrize("task", ["eval", "predict", "export"])
def test_cli_tasks_match_the_jax_cli(trained_checkpoint, no_jax_native,
                                     task):
    tmp, flags = trained_checkpoint
    extra = {"export": [f"--export_dir={tmp}/export_WHO"]}.get(task, [])
    out = {}
    for who, main in (("jax", jtrain_ctr.main), ("port", train_ctr.main)):
        out[who] = main([task] + flags + [a.replace("WHO", who)
                                          for a in extra])
    if task == "eval":
        assert out["port"]["count"] == out["jax"]["count"] == 7 * 128
        assert out["port"]["auc"] == out["jax"]["auc"]
    elif task == "predict":
        assert out["port"]["probs"].shape == out["jax"]["probs"].shape
        np.testing.assert_allclose(out["port"]["probs"].mean(),
                                   out["jax"]["probs"].mean(), atol=1e-5)
    else:
        got, want = (_checkpoint_leaves(tmp / f"export_{who}" / "step_0")
                     for who in ("port", "jax"))
        assert got.keys() == want.keys() and len(got) > 5
        for path in got:
            np.testing.assert_array_equal(got[path], want[path],
                                          err_msg=path)
