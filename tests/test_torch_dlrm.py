"""DLRM-DCNv2 in the port (``models/dlrm.py``) against its plain reference
(``benchmark/models/dlrm.py``: plain torch, autograd on the gathered rows, a
dense table gradient and a dense row-wise Adagrad over every row), at a
small size on the CPU: 4 fields of 300, 20, 5,000 and 60 rows with bags of
3, 1, 5 and 2 ids, dim 8, bottom MLP 16-8, two cross layers of rank 4, top
MLP 32-16-1, batch 64, on seeded weights and a set made by the cell's
generator.

Tolerances, each with its reason:

- the logits and the loss: the same float32 operations in the same order
  on the same operands (the row gather is a copy), so 1e-6 relative;
- the gradients: every dense leaf's is autograd's on the same graph, the
  table's touched rows the same adds in the ids' order (the port's sparse
  segment sum, the reference's ``index_add_``), so 1e-6 relative plus
  1e-9 absolute. A gradient through TF32 products (the reference's
  control, `reference.to_tf32`'s rounding) misses it by orders of
  magnitude;
- three Adagrad steps: the first moves a weight by about lr·g/|g| = 5e-3,
  so a few ulps of that: 2e-7 absolute plus 1e-6 relative;
- rows and accumulators no step touched: bitwise unchanged.
"""

import numpy as np
import pytest
import torch

from benchmark import dlrm_data, port_dlrm
from benchmark.kinds import devgen_dlrm_train as kind
from benchmark.models import criteo
from benchmark.models import dlrm as ref
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.ops import segment_sum as ss
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling

CONFIG = {
    "num_embeddings_per_feature": [300, 20, 5000, 60],
    "published_num_embeddings_per_feature": [3000, 20, 40000, 60],
    "multi_hot_sizes": [3, 1, 5, 2], "embedding_dim": 8,
    "num_dense_features": 13, "dense_arch_layer_sizes": [16, 8],
    "over_arch_layer_sizes": [32, 16, 1], "dcn_num_layers": 2,
    "dcn_low_rank_dim": 4, "learning_rate": 0.005, "eps": 1e-8}
TRAFFIC = {"rows": 600, "batch": 64, "id_skew": 2.2,
           "planted": {"bias": -1.2, "effect_scale": 0.35,
                       "dense_scale": 0.15, "interaction_rank": 4,
                       "interaction_scale": 0.14}}
GRAD_TOL = dict(rtol=1e-6, atol=1e-9)
STEP_TOL = dict(rtol=1e-6, atol=2e-7)


def _setup(seed):
    torch.set_num_threads(2)
    data = dlrm_data.make_dataset(CONFIG, TRAFFIC, seed, "cpu")
    weights = kind.weights(CONFIG, seed, "cpu")
    return data, weights


def _batch(data, seed, step=0):
    idx = ref.batch_indices(TRAFFIC, seed, step, TRAFFIC["rows"], "cpu")
    return {k: v[idx] for k, v in data.items()}


def _clone(tree):
    return {p: t.clone() for p, t in criteo.paths(tree)}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_logits_and_loss_match_the_reference(seed):
    data, weights = _setup(seed)
    model = port_dlrm.model(CONFIG)
    batch = _batch(data, seed)
    logits, _ = model.apply(weights, {}, batch, train=False)
    gids = ref.global_ids(CONFIG, batch["ids"])
    want = ref.forward(CONFIG, weights, weights["table"][gids],
                       batch["dense"], torch.matmul)
    torch.testing.assert_close(logits, want, rtol=1e-6, atol=0)
    loss, _, _ = TS.loss_and_grads(model, weights, {}, batch)
    result = ref.train_steps(CONFIG, TRAFFIC, weights, data, seed, 1)
    assert float(loss) == pytest.approx(result["losses"][0], rel=1e-6)


def _port_grads(seed):
    data, weights = _setup(seed)
    model = port_dlrm.model(CONFIG)
    _, _, grads = TS.loss_and_grads(model, weights, {}, _batch(data, seed))
    return data, weights, grads


@pytest.mark.parametrize("precision,within", [("fp32", True),
                                              ("tf32", False)])
def test_gradients_match_the_reference_and_tf32_misses(precision, within):
    """Every dense leaf's gradient and the table's touched rows' summed
    gradients against the reference's dense gradient; the reference in
    TF32 misses the dense leaves' tolerance."""
    seed = 3
    data, weights, grads = _port_grads(seed)
    result = ref.train_steps(CONFIG, TRAFFIC, weights, data, seed, 1,
                             precision=precision, keep=True)
    want = result["grad0_tree"]
    sparse = grads["table"]
    assert isinstance(sparse, ss.SparseRows)
    n = TRAFFIC["batch"] * sum(CONFIG["multi_hot_sizes"])
    assert sparse.rows.shape == (n, CONFIG["embedding_dim"])
    count = int(sparse.count)
    ids = sparse.ids[:count]
    assert torch.equal(ids, torch.nonzero(want["table"].abs().sum(1))[:, 0])
    dense_close = all(torch.allclose(grads_leaf, want_leaf, **GRAD_TOL)
                      for (p, grads_leaf), (_, want_leaf) in zip(
                          criteo.paths({k: v for k, v in grads.items()
                                        if k != "table"}),
                          criteo.paths({k: v for k, v in want.items()
                                        if k != "table"}), strict=True))
    assert dense_close == within
    if within:
        torch.testing.assert_close(sparse.rows[:count], want["table"][ids],
                                   **GRAD_TOL)


def test_three_update_steps_match_the_reference():
    """The port's graph-free K-step call (three steps from the same
    weights and per-step rows) against the reference's three steps; the
    rows and accumulators no step touched stay bitwise as they were."""
    seed = 4
    data, weights = _setup(seed)
    start = _clone(weights)
    model = port_dlrm.model(CONFIG)
    ts, tx = port_dlrm.train_state(model, CONFIG, weights, seed, "cpu")
    steps = fast.make_scanned_train_step_devgen(model, tx, TRAFFIC["rows"],
                                                TRAFFIC["batch"])
    ts, _ = steps(ts, data, 3, 0)
    result = ref.train_steps(CONFIG, TRAFFIC, kind.weights(CONFIG, seed,
                                                           "cpu"),
                             data, seed, 3, keep=True)
    for (p, got), (_, want) in zip(criteo.paths(ts.params),
                                   criteo.paths(result["params"]),
                                   strict=True):
        torch.testing.assert_close(got, want, **STEP_TOL, msg=str(p))
    acc = ts.opt_state.acc["table"]
    touched = acc != 0
    untouched = ~touched
    assert untouched.any() and touched.any()
    table = ts.params["table"]
    assert torch.equal(table[untouched], start[("table",)][untouched])
    moved = (table != start[("table",)]).any(dim=1)
    assert torch.equal(moved, touched)


def test_the_table_gradient_is_never_dense():
    """A step hands the optimizer the touched rows (N = B·S places, not the
    table's V rows), and the batch's ids are the counted ones."""
    seed = 5
    data, weights = _setup(seed)
    model = port_dlrm.model(CONFIG)
    ts, tx = port_dlrm.train_state(model, CONFIG, weights, seed, "cpu")
    seen = []
    real = tx.update

    def spy(grads, state, params):
        seen.append(grads["table"])
        return real(grads, state, params)

    steps = fast.make_scanned_train_step_devgen(
        model, tx._replace(update=spy), TRAFFIC["rows"], TRAFFIC["batch"])
    steps(ts, data, 2, 0)
    n = TRAFFIC["batch"] * sum(CONFIG["multi_hot_sizes"])
    assert [tuple(g.rows.shape) for g in seen] == [(n, 8)] * 2
    counts = model.meta["bag_counter"].totals("cpu")
    assert counts["ids"] == 2 * n
    assert counts["unique"] == sum(int(g.count) for g in seen)


def test_a_dlrm_step_marks_its_units_in_order(monkeypatch):
    """An eager step calls the bags' and the cross's unit marks in the
    order a device trace reads them (on the CPU the marks launch
    nothing): forward, then the backward's from the top down."""
    called = []
    real = profiling.mark

    def mark(name, like):
        called.append(name)
        real(name, like)

    monkeypatch.setattr(profiling, "mark", mark)
    seed = 6
    data, weights = _setup(seed)
    model = port_dlrm.model(CONFIG)
    ts, tx = port_dlrm.train_state(model, CONFIG, weights, seed, "cpu")
    fast.make_scanned_train_step_devgen(model, tx, TRAFFIC["rows"], 32)(
        ts, data, 1, 0)
    assert called == ["begin", "forward", "bags_forward", "bags_forward_end",
                      "cross_forward", "cross_forward_end", "backward",
                      "cross_backward", "cross_backward_end",
                      "bags_backward", "bags_backward_end", "optimizer",
                      "end"]
    assert set(profiling.UNITS["bags"] + profiling.UNITS["cross"]) <= \
        set(called)


def test_a_table_read_twice_in_a_step_is_refused():
    gids = torch.tensor([[0, 1], [2, 3]])
    sink = emb_table.SparseTable(torch.randn(5, 4))
    out = emb_table.bag_sum(sink, gids, (1, 1)).sum() + \
        emb_table.bag_sum(sink, gids, (2,)).sum()
    with pytest.raises(RuntimeError, match="more than one bag"):
        torch.autograd.grad(out, [sink.token])


def test_the_bags_sum_each_fields_span():
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    gids = torch.tensor([[1, 2, 3, 9], [0, 0, 5, 6]])
    pooled = emb_table.bag_sum(table, gids, (3, 1))
    want = np.stack([[table[[1, 2, 3]].sum(0).numpy(), table[9].numpy()],
                     [table[[0, 0, 5]].sum(0).numpy(), table[6].numpy()]])
    assert torch.equal(pooled, torch.from_numpy(want))
    with pytest.raises(ValueError, match="4 ids a row"):
        emb_table.bag_sum(table, gids, (2, 1))
