"""The K-step calls' in-place step body (what a CUDA graph captures on the
card) on the CPU, where the scanned functions run it eagerly, at a small
config (vocabs ``(50,)*20 + (3000,)*6``, embedding dim 4, towers 8-8,
2 cross layers, CIN 5-3):

- 3 devgen steps through the in-place body leave the parameters, the BN
  moving stats, the optimizer state and the mean loss bitwise equal to the
  functional eager loop (`train_state.make_train_step`, the step the
  port's K-step calls ran before they were graphed), dropout 0.5 where the
  model has a tower;
- the host-index call through the same body, at dropout 0, against JAX
  ``fast.make_scanned_train_step`` (tolerance 2e-5 on the parameters, as
  in tests/test_torch_train.py: Adam's first steps move each weight by
  about lr·sign(g) = 1e-3, so a gradient that differs by rounding moves a
  weight by a few ulps of 1e-3 per step);
- the eval call's in-place metric state bitwise equal to the functional
  eval loop;
- ``graphed=True`` on CPU tensors raises; the graph's key tells storage
  and generators apart;
- the graphed K-step loop with the graph stood in for (the warm-up is
  step 0, the host's part runs before each replay, a graph is reused for
  the same storage and captured anew for other storage): bitwise the
  eager calls;
- ``profile_step``'s modes: graphed by default, ``--eager``, or both in
  ``--pairs=N``.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.train import fast as jfast
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import profile_step
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim, step_graph
from recsys_tpu_torch.train import train_state as TS
from test_torch_train import _assert_trees_close

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(embedding_dim=4, deep_layers=(8, 8), cross_layers=2,
             cin_layers=(5, 3), use_bn=True)
LR = {"wide": 4.0}
# (model, engine, dropout): DeepFM on the split engine, DCN on the fused
# one, wide with FTRL, xDeepFM through the plain CIN
BODY_CASES = [("deepfm", "split", 0.5), ("dcn", "fused", 0.5),
              ("wide", "split", 0.0), ("xdeepfm", "split", 0.5)]


def _model(name, engine, dropout):
    return make_model(name, CriteoConfig(cat_vocabs=VOCABS),
                      ModelConfig(name=name, emb_engine=engine,
                                  dropout=dropout, **SMALL))


def _data(n, start_row=0):
    return jcriteo.synthetic_criteo(n, JCriteo(cat_vocabs=VOCABS),
                                    start_row=start_row)


def _state_leaves(ts):
    return tree_util.leaves((ts.params, ts.model_state, ts.opt_state))


def _functional_devgen(model, tx, ts, data, k, first_step, n_rows, b):
    """The devgen call as the functional eager loop: `make_train_step`
    on indices from ``torch.randint``, a new train state each step."""
    step = TS.make_train_step(model, tx)
    total = torch.zeros(())
    for i in range(k):
        TS.reseed(ts, first_step + i)
        idx = torch.randint(0, n_rows, (b,), generator=ts.rng)
        ts, loss = step(ts, {key: v.index_select(0, idx)
                             for key, v in data.items()})
        total = total + loss
    return ts, total / k


@pytest.mark.parametrize("name,engine,dropout", BODY_CASES,
                         ids=[c[0] for c in BODY_CASES])
def test_inplace_body_is_the_functional_step_bitwise(name, engine, dropout):
    model = _model(name, engine, dropout)
    lr = LR.get(name, 1e-2)
    data = fast.stage_dataset(_data(512), "cpu")
    (ts_a, tx_a), (ts_b, tx_b) = (
        TS.create_train_state(model, 7, lr, "cpu") for _ in range(2))
    steps = fast.make_scanned_train_step_devgen(model, tx_a, 512, 64)

    ts_a, loss_a = steps(ts_a, data, 3, 4)
    ts_b, loss_b = _functional_devgen(model, tx_b, ts_b, data, 3, 4, 512, 64)

    assert int(ts_a.step) == int(ts_b.step) == 3
    assert torch.equal(loss_a, loss_b)
    leaves_a, leaves_b = _state_leaves(ts_a), _state_leaves(ts_b)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b)
    if name != "wide":
        # BN's moving stats moved, and landed in the state's own tensors
        assert any(not torch.equal(m, torch.zeros_like(m))
                   for m in tree_util.leaves(ts_a.model_state))


@pytest.mark.parametrize("name,engine", [("deepfm", "split"),
                                         ("dcn", "fused"), ("wide", "split")])
def test_host_index_call_matches_jax(name, engine):
    kw = dict(SMALL, name=name, emb_engine=engine, dropout=0.0)
    jm = jmake(name, JCriteo(cat_vocabs=VOCABS), JModel(**kw))
    tm = make_model(name, CriteoConfig(cat_vocabs=VOCABS), ModelConfig(**kw))
    lr = LR.get(name, 1e-3)
    jts, jtx = JTS.create_train_state(jm, seed=2, learning_rate=lr)
    port_ts = convert.convert_train_state(jax.tree.map(
        np.asarray, jts._replace(rng=jax.random.key_data(jts.rng))))
    data = _data(512)
    idx = np.random.default_rng(9).integers(0, 512, (4, 48))

    jts, jloss = jfast.make_scanned_train_step(jm, jtx)(
        jts, jfast.stage_dataset(data), jnp.asarray(idx, jnp.int32))
    steps = fast.make_scanned_train_step(tm, optim.for_model(tm.meta, lr),
                                         graphed=False)
    port_ts, loss = steps(port_ts, fast.stage_dataset(data, "cpu"), idx)

    assert int(port_ts.step) == int(jts.step) == 4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(port_ts.params, jts.params, atol=2e-5, rtol=0)
    _assert_trees_close(port_ts.model_state, jts.model_state, atol=1e-5,
                        rtol=1e-5)


@pytest.mark.parametrize("name", ["deepfm", "xdeepfm"])
def test_inplace_eval_is_the_functional_eval_bitwise(name):
    model = _model(name, "split", 0.5)
    ts, _ = TS.create_train_state(model, 3, 1e-3, "cpu")
    data = fast.stage_dataset(_data(600, start_row=10 ** 6), "cpu")
    idx = np.arange(4 * 128).reshape(4, 128)
    start = M.init_binary_metrics()
    start.count.fill_(5.0)          # a state carried in from earlier calls

    got = fast.make_scanned_eval(model)(ts.params, ts.model_state, data, idx,
                                        start)
    eval_step = TS.make_eval_step(model)
    want = start
    for row in torch.as_tensor(idx):
        want = eval_step(ts.params, ts.model_state, want,
                         {k: v.index_select(0, row) for k, v in data.items()})
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert float(got.count) == 5.0 + 4 * 128
    assert float(start.count) == 5.0          # the caller's state is kept


def test_graphed_true_on_cpu_tensors_raises():
    model = _model("deepfm", "split", 0.0)
    ts, tx = TS.create_train_state(model, 0, 1e-3, "cpu")
    data = fast.stage_dataset(_data(256), "cpu")
    idx = np.zeros((2, 32), np.int64)
    with pytest.raises(ValueError, match="make_scanned_train_step_devgen"):
        fast.make_scanned_train_step_devgen(model, tx, 256, 32,
                                            graphed=True)(ts, data, 2, 0)
    with pytest.raises(ValueError, match="make_scanned_train_step: "):
        fast.make_scanned_train_step(model, tx, graphed=True)(ts, data, idx)
    with pytest.raises(ValueError, match="make_scanned_eval"):
        fast.make_scanned_eval(model, graphed=True)(
            ts.params, ts.model_state, data, idx, M.init_binary_metrics())
    assert int(ts.step) == 0            # nothing ran


def test_graph_key_tells_storage_and_generators_apart():
    a, b = torch.zeros(4), torch.zeros(4)
    gen = torch.Generator()
    key = step_graph.signature(({"x": a}, gen))
    assert step_graph.signature(({"x": a}, gen)) == key
    assert step_graph.signature(({"x": a.clone()}, gen)) != key
    assert step_graph.signature(({"y": a}, gen)) != key
    assert step_graph.signature(({"x": b}, gen)) != key
    assert step_graph.signature(({"x": a}, torch.Generator())) != key
    assert step_graph.signature(({"x": a.view(2, 2)}, gen)) != key
    assert step_graph.use_graph(None, torch.device("cuda"), "f")
    assert not step_graph.use_graph(None, torch.device("cpu"), "f")
    assert not step_graph.use_graph(False, torch.device("cuda"), "f")


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """CUDA graphs stood in for on the CPU: `StepGraph.capture` runs the
    warm-up step and keeps the step itself, `replay` runs it again. What
    is left to test is the K-step loop around the graph: which step is
    the warm-up, what the host does before each replay, when a graph is
    reused and when it is captured anew. → the list of captures."""
    captures = []

    def capture(self, held, static, step, generators=()):
        self.reset()
        step()
        self._graph, self._key = step, step_graph.signature(held)
        self._held, self.static = held, static
        captures.append(self.name)

    monkeypatch.setattr(step_graph.StepGraph, "capture", capture)
    monkeypatch.setattr(step_graph.StepGraph, "replay",
                        lambda self: self._graph())
    monkeypatch.setattr(step_graph, "use_graph",
                        lambda graphed, device, name: graphed is not False)
    return captures


def test_graphed_k_step_loop_reuses_and_recaptures(stand_in_graphs):
    model = _model("deepfm", "split", 0.5)
    data = fast.stage_dataset(_data(512), "cpu")
    other = fast.stage_dataset(_data(512, start_row=999), "cpu")
    runs = {}
    for graphed in (False, True):
        ts, tx = TS.create_train_state(model, 7, 1e-2, "cpu")
        devgen = fast.make_scanned_train_step_devgen(model, tx, 512, 64,
                                                     graphed=graphed)
        host = fast.make_scanned_train_step(model, tx, graphed=graphed)
        evals = fast.make_scanned_eval(model, graphed=graphed)
        losses, metrics = [], []
        for c, (k, d) in enumerate([(1, data), (3, data), (2, other)]):
            ts, loss = devgen(ts, d, k, 4 * c)
            losses.append(loss)
            ts, loss = host(ts, d, np.arange(2 * 64).reshape(2, 64) + c)
            losses.append(loss)
            metrics.append(evals(ts.params, ts.model_state, d,
                                 np.arange(128).reshape(2, 64),
                                 M.init_binary_metrics()))
        runs[graphed] = (ts, losses, metrics)
    (ts_e, l_e, m_e), (ts_g, l_g, m_g) = runs[False], runs[True]
    assert int(ts_e.step) == int(ts_g.step) == 12
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    for a, b in zip(_state_leaves(ts_e), _state_leaves(ts_g), strict=True):
        assert torch.equal(a, b)
    for me, mg in zip(m_e, m_g, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(me, mg, strict=True))
    # each function captures on its first call and again for the other
    # data, not when training changed the values it reads: a graph is
    # keyed by storage, and the steps write in place
    assert stand_in_graphs == [
        "make_scanned_train_step_devgen", "make_scanned_train_step",
        "make_scanned_eval",
        "make_scanned_train_step_devgen", "make_scanned_train_step",
        "make_scanned_eval"]


def test_profile_step_times_the_graphed_path_by_default():
    argv = ["dcn", "--batch=512"]
    assert profile_step.parse(argv) == ([("dcn", "split")], 512)
    assert profile_step.parse_modes(argv) == (("graphed",), 1)
    assert profile_step.parse_modes(argv + ["--eager"]) == (("eager",), 1)
    assert profile_step.parse(argv + ["--pairs=3"])[1] == 512
    assert profile_step.parse_modes(["--pairs=3"]) == (
        ("eager", "graphed"), 3)
    with pytest.raises(SystemExit, match="exclude"):
        profile_step.parse_modes(["--eager", "--pairs=2"])


def test_graphed_eval_at_a_new_width_captures_anew(stand_in_graphs):
    """A graphed eval call at a batch width other than the captured one
    captures again: it gives the eager call's metric state exactly (a
    width-1 call after a width-64 call counts 2 examples, not 128) and a
    width-32 call runs where replaying the width-64 graph raises."""
    model = _model("deepfm", "split", 0.0)
    ts, _ = TS.create_train_state(model, 3, 1e-3, "cpu")
    data = fast.stage_dataset(_data(256), "cpu")
    graphed = fast.make_scanned_eval(model, graphed=True)
    eager = fast.make_scanned_eval(model, graphed=False)
    for b in (64, 1, 32):
        idx = np.arange(2 * b).reshape(2, b)
        got = graphed(ts.params, ts.model_state, data, idx,
                      M.init_binary_metrics())
        want = eager(ts.params, ts.model_state, data, idx,
                     M.init_binary_metrics())
        assert float(got.count) == 2 * b
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w)
    assert stand_in_graphs == ["make_scanned_eval"] * 3


def test_graphed_train_call_at_a_new_width_captures_anew(stand_in_graphs):
    model = _model("deepfm", "split", 0.0)
    data = fast.stage_dataset(_data(256), "cpu")
    runs = []
    for graphed in (False, True):
        ts, tx = TS.create_train_state(model, 3, 1e-2, "cpu")
        steps = fast.make_scanned_train_step(model, tx, graphed=graphed)
        losses = []
        for b in (64, 1, 32):
            ts, loss = steps(ts, data, np.arange(2 * b).reshape(2, b) + b)
            losses.append(loss)
        runs.append((losses, _state_leaves(ts)))
    (l_e, p_e), (l_g, p_g) = runs
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(p_e, p_g, strict=True))
    assert stand_in_graphs == ["make_scanned_train_step"] * 3


def test_a_launch_tally_counts_its_own_stream_only(monkeypatch):
    """`cuda_build.launch_tally` (what a graph capture takes back and adds
    at each replay) counts the launches made on its stream, from any
    thread (autograd's backward thread launches on the capturing stream),
    and none made on another stream meanwhile. `StepGraph` takes a
    capture's tally back from the registry and adds it again at each
    replay, whatever counter names it holds (CUDA's graph and streams
    stood in for)."""
    from recsys_tpu_torch.ops import cuda_build

    cuda_build.count("row_gather", 7)   # no tally open
    with cuda_build.launch_tally(7) as tally:
        cuda_build.count("row_gather", 7)
        other = threading.Thread(target=lambda: [
            cuda_build.count("segment_sum", 7),
            cuda_build.count("segment_sum", 8)])
        other.start()
        other.join(10)
        cuda_build.count("row_gather", 9)
    assert not other.is_alive()
    assert tally == {"row_gather": 1, "segment_sum": 1}
    cuda_build.count("row_gather", 7)   # closed: no error
    assert tally["row_gather"] == 1

    class Stream:
        cuda_stream = 7

        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def capture_begin(self, **kwargs):
            pass

        def capture_end(self):
            pass

        def replay(self):
            pass

    for name, stand_in in [("Stream", Stream), ("CUDAGraph", Graph),
                           ("current_stream", Stream),
                           ("stream", lambda s: contextlib.nullcontext()),
                           ("synchronize", lambda device=None: None),
                           ("empty_cache", lambda: None)]:
        monkeypatch.setattr(torch.cuda, name, stand_in)
    name = "a.counter.that.no.list.declares"
    graph = step_graph.StepGraph("f")
    static = [torch.zeros(1)]
    with cuda_build.counting() as launches:
        graph.capture((), static, lambda: cuda_build.count(name, 7, 3))
    assert launches == {name: 3}           # the warm-up step, not the capture
    with cuda_build.counting() as launches:
        for _ in range(4):
            graph.replay()
    assert launches == {name: 12}
