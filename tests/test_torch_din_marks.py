"""DIN's unit marks and attention counter in the port's training step
(``models/din.py``, ``ops/interactions.py``, ``utils/profiling.py``), and
DIN through the device-resident K-step call.

On the CPU: a DIN step calls its four unit marks between the section marks,
in order, and reaches no mark library; a Criteo step calls none of them;
the counter's sums are the rows the attention computed and the history's
real positions; DIN's devgen call equals the host-index call on the same
indices. On the card (marker ``gpu``, skipped without one): DIN graphed
equals DIN eager bitwise after 50 steps of the devgen call, every replay
runs the unit marks in order inside its sections, and a Criteo replay runs
none. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_din_marks.py
"""

import pytest
import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data import amazon
from recsys_tpu_torch.data.criteo import synthetic_criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import interactions
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling

ITEMS, CATES = 300, 13
#: the marks a DIN step calls, in order (``begin`` from the K-step call)
DIN_MARKS = ["begin", "forward", "attention_forward",
             "attention_forward_end", "backward", "attention_backward",
             "attention_backward_end", "optimizer", "end"]


def _din(dropout=0.1):
    return make_model("din", ITEMS, CATES, ModelConfig(
        name="din", embedding_dim=8, attention_layers=(16, 8),
        mlp_layers=(16, 8, 4), use_bn=False, dropout=dropout))


def _din_data(device="cpu"):
    ds = amazon.synthetic_din(n_users=300, item_vocab=ITEMS,
                              cate_vocab=CATES, seed=3)
    return fast.stage_dataset(
        {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
         "hist_cate": ds.hist_cate, "label": ds.label}, device)


def _criteo(device="cpu"):
    ccfg = CriteoConfig(cat_vocabs=(50,) * 26)
    model = make_model("deepfm", ccfg, ModelConfig(
        name="deepfm", embedding_dim=4, deep_layers=(8,), dropout=0.5))
    return model, fast.stage_dataset(synthetic_criteo(512, ccfg), device)


def _spy(monkeypatch):
    """The names ``profiling.mark`` is called with, in order; the marks'
    library may not be reached."""
    called = []
    real = profiling.mark

    def mark(name, like):
        called.append(name)
        real(name, like)

    def no_library():
        raise AssertionError("an eager step on the CPU reached the marks' "
                             "library")

    monkeypatch.setattr(profiling, "mark", mark)
    monkeypatch.setattr(profiling, "_mark_lib", no_library)
    return called


def test_a_din_step_marks_its_attention_units_in_order(monkeypatch):
    called = _spy(monkeypatch)
    data = _din_data()
    ts, tx = TS.create_train_state(_din(), 0, 1e-3, "cpu")
    steps = fast.make_scanned_train_step_devgen(
        _din(), tx, data["label"].shape[0], 32)
    steps(ts, data, 2, 0)
    assert called == DIN_MARKS * 2
    assert set(profiling.UNIT_MARKS) <= set(called)


def test_a_criteo_step_calls_no_unit_mark(monkeypatch):
    called = _spy(monkeypatch)
    model, data = _criteo()
    ts, tx = TS.create_train_state(model, 0, 1e-3, "cpu")
    fast.make_scanned_train_step_devgen(model, tx, 512, 64)(ts, data, 2, 0)
    assert called == list(profiling.MARKS) * 2


def test_a_backward_mark_passes_the_gradients_on_unchanged(monkeypatch):
    called = _spy(monkeypatch)
    x = torch.randn(3, 4, requires_grad=True)
    y = torch.randn(5, requires_grad=True)
    a, b = profiling.backward_mark("attention_backward", x * 2.0, y)
    assert called == []
    (a.sum() * 3.0 + (b * b).sum()).backward()
    assert called == ["attention_backward"]
    assert torch.equal(x.grad, torch.full((3, 4), 6.0))
    assert torch.equal(y.grad, 2.0 * y.detach())


def test_the_counter_sums_rows_and_real_positions():
    model, data = _din(), _din_data()
    ts, tx = TS.create_train_state(model, 0, 1e-3, "cpu")
    counter = model.meta["attention_counter"]
    assert counter.names == interactions.ATTENTION_COUNTS
    assert counter.totals("cpu") is None
    n, p = data["hist_iid"].shape
    idx = torch.randint(0, n, (3, 32), generator=torch.Generator()
                        .manual_seed(1))
    fast.make_scanned_train_step(model, tx)(ts, data, idx)
    real = sum(int((data[k][idx[i]] != 0).sum())
               for i in range(3) for k in ("hist_iid", "hist_cate"))
    assert counter.totals("cpu") == {"rows": 2 * 3 * 32 * p, "real": real}
    # eval and serving count nothing
    model.apply(ts.params, ts.model_state, fast._take(data, idx[0]),
                train=False)
    assert counter.totals("cpu")["rows"] == 2 * 3 * 32 * p


def test_a_counter_refuses_the_wrong_number_of_values():
    counter = profiling.DeviceCounter(("a", "b"))
    with pytest.raises(ValueError, match="1 values"):
        counter.add(torch.zeros(1), 3)


@pytest.mark.parametrize("launcher, prefix, names", [
    ("recsys_mark", "recsys_mark_", profiling.MARKS),
    ("recsys_unit_mark", "recsys_unit_", profiling.UNIT_MARKS)])
def test_the_mark_source_launches_each_mark_by_its_index(launcher, prefix,
                                                         names):
    """``csrc/step_marks.cu`` (built only on the card): each launcher's
    case ``i`` launches the kernel of the ``i``-th name."""
    import re

    with open(profiling.MARK_SOURCE) as f:
        src = f.read()
    body = src[src.index(f"int {launcher}(int which"):]
    body = body[:body.index("default:")]
    cases = re.findall(r"case (\d+): (\w+)<<<", body)
    assert cases == [(str(i), prefix + n) for i, n in enumerate(names)]
    for n in names:
        assert f"__global__ void {prefix}{n}() {{}}" in src


def _leaves(ts):
    return tree_util.leaves((ts.params, ts.model_state, ts.opt_state))


def test_din_devgen_call_is_the_host_index_call_on_its_indices():
    """K = 4 devgen steps at dropout 0.1, and the host-index call one step
    a call on the indices each devgen step draws, the generator reseeded as
    the devgen call reseeds it (so the dropout masks that follow agree):
    bitwise the same state and losses on the CPU."""
    model, data = _din(), _din_data()
    n, b, k, seed = data["label"].shape[0], 32, 4, 11
    ts_a, tx = TS.create_train_state(model, seed, 1e-3, "cpu")
    ts_a, loss_a = fast.make_scanned_train_step_devgen(model, tx, n, b)(
        ts_a, data, k, 0)
    ts_b, tx_b = TS.create_train_state(model, seed, 1e-3, "cpu")
    host = fast.make_scanned_train_step(model, tx_b)
    loss_sum = torch.zeros(())
    for s in range(k):
        TS.reseed(ts_b, s)
        idx = torch.empty((b,), dtype=torch.int64)
        idx.random_(0, n, generator=ts_b.rng)
        ts_b, loss = host(ts_b, data, idx[None])
        loss_sum += loss
    assert torch.equal(loss_a, loss_sum / k)
    for x, y in zip(_leaves(ts_a), _leaves(ts_b), strict=True):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the marks and the graphs run on "
                    "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _device_names(prof) -> list:
    from torch.autograd import DeviceType

    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]


@pytest.mark.gpu
def test_din_graphed_equals_eager_after_50_devgen_steps(cuda_device):
    data = _din_data(cuda_device)
    n = data["label"].shape[0]
    out = {}
    for graphed in (False, True):
        model = _din()
        ts, tx = TS.create_train_state(model, 5, 1e-3, cuda_device)
        steps = fast.make_scanned_train_step_devgen(model, tx, n, 64,
                                                    graphed=graphed)
        losses = []
        for c in range(2):
            ts, loss = steps(ts, data, 25, 25 * c)
            losses.append(loss)
        out[graphed] = (ts, losses, model.meta["attention_counter"]
                        .totals(cuda_device))
    (ts_e, l_e, c_e), (ts_g, l_g, c_g) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g))
    for a, b in zip(_leaves(ts_e), _leaves(ts_g), strict=True):
        assert torch.equal(a, b), float((a - b).abs().max())
    # a replay adds what an eager step adds
    assert c_e == c_g and c_g["rows"] == 2 * 50 * 64 * data[
        "hist_iid"].shape[1]


@pytest.mark.gpu
def test_replays_run_the_unit_marks_inside_their_sections(cuda_device):
    """Graphed calls of K = 4 (the first captures: its step 0 is the eager
    warm-up): every DIN replay runs the section and unit marks in
    `DIN_MARKS`' order; a DeepFM replay runs its five section marks and no
    unit mark."""
    from torch.profiler import ProfilerActivity, profile

    din_data = _din_data(cuda_device)
    deepfm, criteo_data = _criteo(cuda_device)
    calls = []
    for m, data in ((_din(), din_data), (deepfm, criteo_data)):
        ts, tx = TS.create_train_state(m, 0, 1e-3, cuda_device)
        calls.append((fast.make_scanned_train_step_devgen(
            m, tx, data["label"].shape[0], 64), ts, data))
    profiling.mark("begin", din_data["label"])      # the build and load
    names = []
    for steps, ts, data in calls:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for c in range(2):
                ts, _ = steps(ts, data, 4, 4 * c)
            torch.cuda.synchronize()
        names.append([n.split("(")[0] for n in _device_names(prof)
                      if n.startswith(("recsys_mark_", "recsys_unit_"))])
    kernel = {m: f"recsys_mark_{m}" for m in profiling.MARKS} | {
        m: f"recsys_unit_{m}" for m in profiling.UNIT_MARKS}
    assert names[0] == [kernel[m] for m in DIN_MARKS] * 7
    assert names[1] == [f"recsys_mark_{m}" for m in profiling.MARKS] * 7

