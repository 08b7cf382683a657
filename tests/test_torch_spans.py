"""The training path's spans and marks (`utils/profiling.py` ``span`` and
``mark``) on the CPU, at a small DeepFM:

- a training call of K steps under ``torch.profiler`` is one
  ``recsys.train.call`` span holding K ``recsys.train.host_step`` spans, of
  FUNCTION scope and no user annotation (a user annotation would be
  mirrored onto the card's track as a device operation); an eval call
  records no span;
- with the mark stood in for by a recorder, every training step of the
  devgen, sampler, host-index and fed paths marks ``begin, forward,
  backward, optimizer, end`` in that order, eagerly and with the graph
  stood in for;
- a mark on a CPU tensor launches nothing and loads no library.
"""

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import ProfilerActivity, profile

from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data.criteo import synthetic_criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling
from test_torch_graph_step import stand_in_graphs  # noqa: F401 (fixture)

CFG = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
N, B, K = 256, 32, 3


def _setup():
    model = make_model("deepfm", CFG, ModelConfig(
        name="deepfm", embedding_dim=4, deep_layers=(8, 8), dropout=0.5))
    ts, tx = TS.create_train_state(model, 0, 1e-3, "cpu")
    return model, ts, tx, fast.stage_dataset(synthetic_criteo(N, CFG), "cpu")


def _sample(gen, tables, batch_size):
    idx = torch.randint(0, N, (batch_size,), generator=gen)
    return {k: v.index_select(0, idx) for k, v in tables.items()}


def _call(path: str, graphed: bool):
    """→ (the steps of one call of ``path``, a function that runs the
    call)."""
    model, ts, tx, data = _setup()
    idx = np.arange(K * B).reshape(K, B) % N
    if path == "devgen":
        steps = fast.make_scanned_train_step_devgen(model, tx, N, B,
                                                    graphed=graphed)
        return K, lambda: steps(ts, data, K, 0)
    if path == "sampler":
        steps = fast.make_scanned_train_step_sampler(model, tx, _sample, B,
                                                     graphed=graphed)
        return K, lambda: steps(ts, data, K, 0)
    if path == "host":
        steps = fast.make_scanned_train_step(model, tx, graphed=graphed)
        return K, lambda: steps(ts, data, idx)
    if path == "fed":
        step = fast.make_fed_train_step(model, tx, graphed=graphed)
        batch = {k: v[:B] for k, v in data.items()}
        return 1, lambda: step(ts, batch, 0)
    evals = fast.make_scanned_eval(model, graphed=graphed)
    return K, lambda: evals(ts.params, ts.model_state, data, idx,
                            M.init_binary_metrics())


@pytest.mark.parametrize("path", ["devgen", "fed", "eval"])
def test_a_call_is_a_span_holding_one_host_step_span_a_step(path):
    k, call = _call(path, graphed=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = [e for e in prof.events() if e.name.startswith("recsys.")]
    assert not any("recsys_mark" in e.name for e in prof.events())
    if path == "eval":
        assert spans == []
        return
    calls = [e for e in spans if e.name == "recsys.train.call"]
    steps = [e for e in spans if e.name == "recsys.train.host_step"]
    assert len(calls) == 1 and len(steps) == k == len(spans) - 1
    (outer,) = calls
    for e in steps:
        assert e.cpu_parent is outer
        assert outer.time_range.start <= e.time_range.start
        assert e.time_range.end <= outer.time_range.end
    for e in spans:
        assert e.scope == int(RecordScope.FUNCTION)
        assert not e.is_user_annotation


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("path", ["devgen", "sampler", "host", "fed", "eval"])
def test_every_step_marks_its_sections_in_order(path, graphed, monkeypatch,
                                                stand_in_graphs):
    """The eval call's steps train nothing and mark nothing."""
    seen = []

    def record(name, like):
        assert isinstance(like, torch.Tensor)
        seen.append(name)

    monkeypatch.setattr(profiling, "mark", record)
    k, call = _call(path, graphed)
    call()
    assert seen == ([] if path == "eval" else list(profiling.MARKS) * k)
    assert len(stand_in_graphs) == int(graphed)     # the stand-in captured


def test_marks_launch_nothing_on_the_cpu(monkeypatch):
    def refuse(src):
        raise AssertionError(f"loaded {src}")

    monkeypatch.setattr(cuda_build, "load", refuse)
    x = torch.zeros(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in profiling.MARKS:
            profiling.mark(name, x)
        _call("devgen", graphed=False)[1]()
    assert not any("recsys_mark" in e.name for e in prof.events())
