"""The DLRM cell on the CPU at a tiny size (4 tables of a few hundred to a
few thousand rows, bags of 1 to 5 ids, dim 8, rank 4, batch 64): a whole
run comes out correct against the plain reference
(``benchmark/models/dlrm.py``), faults planted in the port make it not
correct, and the TF32 control fails a number the port passes; the
generator's set, the counts of work, and the readers of the cell's five
per-layer metrics on summaries made by hand."""

import json
import os

import pytest
import torch

from benchmark import control, dlrm_data, run, spec, trace
from benchmark.models import dlrm
from recsys_tpu_torch.ops import interactions
from recsys_tpu_torch.train import optim

CELL = "dlrm-dcnv2-criteo1tb.train-b8192"
TINY = {"num_embeddings_per_feature": [300, 20, 5000, 60],
        "published_num_embeddings_per_feature": [3000, 20, 40000, 60],
        "multi_hot_sizes": [3, 1, 5, 2], "embedding_dim": 8,
        "dense_arch_layer_sizes": [16, 8], "over_arch_layer_sizes": [32, 16, 1],
        "dcn_num_layers": 2, "dcn_low_rank_dim": 4}


def _full():
    return spec.load_cell(CELL)


@pytest.fixture
def dlrm_cell(tmp_path):
    """A tiny DLRM cell of its own checkout in ``tmp_path``, with the full
    cell's limits."""
    torch.set_num_threads(2)
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (here / d).mkdir(parents=True)
    full = _full()
    config = dict(full["config"], name="dlrm-tiny", **TINY)
    traffic = dict(full["traffic"], rows=2000, batch=64, steps_per_call=2)
    name = "dlrm-tiny.train-b64"
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dlrm-tiny", "source": "test",
                             "file": "benchmark/configs/dlrm-tiny.json",
                             "reduced": sorted(TINY), "why": "test"})
    bench["workloads"].append({"name": name, "config": "dlrm-tiny",
                               "traffic": "tiny-dlrm", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    for path, obj in ((tmp_path / "BENCHMARK.json", bench),
                      (here / "configs" / "dlrm-tiny.json", config),
                      (here / "traffic" / "tiny-dlrm.json", traffic),
                      (here / "limits" / f"{name}.json", full["limits"])):
        path.write_text(json.dumps(obj))
    return spec.load_cell(name, str(tmp_path))


def _run(cell, seed=2 ** 31 + 77):
    return run.run_cell(cell, seed, 0.1, False, torch.device("cpu"))


def test_a_tiny_dlrm_cell_is_correct_on_the_cpu(dlrm_cell):
    result = _run(dlrm_cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert {"grad_gap.tables", "grad_gap.cross",
            "change_gap.whole"} <= set(result["checks"])


def _row_left_unupdated(monkeypatch):
    """Row-wise Adagrad skips the last distinct row of every step."""
    real = optim.rowwise_update

    def fault(table, acc, grad, lr, eps):
        real(table, acc, grad._replace(count=grad.count - 1), lr, eps)

    monkeypatch.setattr(optim, "rowwise_update", fault)


def _accumulator_not_added(monkeypatch):
    """The rows move, but their accumulators keep their old values."""
    real = optim.rowwise_update

    def fault(table, acc, grad, lr, eps):
        before = acc.clone()
        real(table, acc, grad, lr, eps)
        acc.copy_(before)

    monkeypatch.setattr(optim, "rowwise_update", fault)


def _cross_bias_dropped(monkeypatch):
    """The cross layers leave out b_l."""
    real = interactions.lowrank_cross_apply

    def fault(params, x0):
        return real([dict(layer, b=torch.zeros_like(layer["b"]))
                     for layer in params], x0)

    monkeypatch.setattr(interactions, "lowrank_cross_apply", fault)


@pytest.mark.parametrize("fault", [_row_left_unupdated,
                                   _accumulator_not_added,
                                   _cross_bias_dropped])
def test_a_fault_in_the_port_is_not_correct(dlrm_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(dlrm_cell)
    assert not result["correct"], result["checks"]


def test_the_control_fails_where_the_port_passes(dlrm_cell):
    names = [k for k in dlrm_cell["limits"] if not k.startswith("_")]
    for seed in (3, 4):
        r = control.readings(dlrm_cell, seed, torch.device("cpu"))
        limit = {k: dlrm_cell["limits"][k]["limit"] for k in names}
        assert all(r["program"][k] <= limit[k] for k in names)
        assert any(r["control"][k] > limit[k] for k in names)
        assert any(r["half_batch"][k] > limit[k] for k in names)


# ------------------------------------------------------------------- the set

def test_the_same_seed_makes_the_same_set(dlrm_cell):
    config, traffic = dlrm_cell["config"], dlrm_cell["traffic"]
    big = 2 ** 31 + 12_345
    a = dlrm_data.make_dataset(config, traffic, big, "cpu")
    b = dlrm_data.make_dataset(config, traffic, big, "cpu")
    c = dlrm_data.make_dataset(config, traffic, big + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ids"], c["ids"])


def test_each_bag_draws_from_its_fields_rows(dlrm_cell):
    config, traffic = dlrm_cell["config"], dlrm_cell["traffic"]
    d = dlrm_data.make_dataset(config, traffic, 7, "cpu", rows=20_000)
    assert d["ids"].dtype == torch.int64
    assert d["ids"].shape == (20_000, sum(TINY["multi_hot_sizes"]))
    assert d["dense"].shape == (20_000, 13)
    slot = 0
    for v, size in zip(TINY["num_embeddings_per_feature"],
                       TINY["multi_hot_sizes"]):
        bag = d["ids"][:, slot:slot + size]
        assert int(bag.min()) >= 0 and int(bag.max()) < v
        # the first id follows u**2.2 (mean V/3.2), the others uniform
        assert float(bag[:, 0].double().mean()) == pytest.approx(
            (v - 1) / 3.2, rel=0.1, abs=0.5)
        if size > 1:
            assert float(bag[:, 1:].double().mean()) == pytest.approx(
                (v - 1) / 2, rel=0.05)
        slot += size
    assert 0.1 < float(d["label"].mean()) < 0.6


# ------------------------------------------------------------------- work

def test_forward_flops_and_embedding_work_by_hand():
    config = _full()["config"]
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    cross = 3 * 2 * 3456 * 512
    top = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256
    assert dlrm.forward_flops(config) == 2 * (bottom + cross + top)
    assert dlrm.forward_flops(config) == 32_060_928
    small = {"embedding_dim": 2, "num_embeddings_per_feature": [5, 7]}
    gather, segment, update = dlrm.embedding_work(small, {"batch": 3},
                                                  ids=10, unique=4)
    assert gather == (8 * 10 + 8 * (4 + 10), 0.0)
    assert segment == (8 * 10 + 4 * 10 + 3 * 2 * 2 * 4 + 8 * 10
                       + 8 * 4 + 8, 2 * 10)
    assert update == (4 * (8 + 8 + 16 + 8), 4 * (5 * 2 + 4))


def test_the_config_holds_one_cards_share():
    config = _full()["config"]
    held = config["num_embeddings_per_feature"]
    published = config["published_num_embeddings_per_feature"]
    assert sum(held) == 26_500_127 and sum(published) == 204_184_588
    for h, p in zip(held, published):
        assert h == (-(-p // 8) if p > 1_000_000 else p)
    assert sum(config["multi_hot_sizes"]) == 214
    assert config["batch_size"] * 8 == config["published_batch_size"]
    assert _full()["traffic"]["batch"] == config["batch_size"]


# ------------------------------------------------------------------ readers

K = 2
#: one replay from its start (µs); marks take 1 µs
REPLAY = [("recsys_mark_begin", 0, 1), ("recsys_mark_forward", 1, 2),
          ("mlp", 2, 4), ("recsys_unit_bags_forward", 4, 5),
          ("void row_gather_kernel<float4>", 5, 15),
          ("reduce", 15, 20), ("recsys_unit_bags_forward_end", 20, 21),
          ("recsys_unit_cross_forward", 21, 22), ("gemm", 22, 60),
          ("recsys_unit_cross_forward_end", 60, 61), ("top", 61, 70),
          ("recsys_mark_backward", 70, 71), ("top_bwd", 71, 90),
          ("recsys_unit_cross_backward", 90, 91), ("gemm_bwd", 91, 160),
          ("recsys_unit_cross_backward_end", 160, 161),
          ("recsys_unit_bags_backward", 161, 162),
          ("prep_keys_sparse", 162, 164),
          ("DeviceRadixSortOnesweepKernel", 164, 170),
          ("segment_chunks<1>", 170, 180),
          ("recsys_unit_bags_backward_end", 180, 181),
          ("mlp_bwd", 181, 185), ("recsys_mark_optimizer", 185, 186),
          ("(anonymous namespace)::rowwise_adagrad_kernel", 186, 196),
          ("multi_tensor_apply_kernel", 196, 199),
          ("recsys_mark_end", 199, 200)]
CROSS_MS = (38 + 69) / 1e3
BAGS_MS = (15 + 18) / 1e3
EMB_US = 10 + 2 + 6 + 10 + 10


def _summary(drop=None, steps=K):
    device = []
    for i in range(K):
        device += [(n, 200 * i + a, 200 * i + b) for n, a, b in REPLAY
                   if not (i == 1 and n == drop)]
    s = trace.summarize(device, [("cudaGraphLaunch", 0.0, 1.0)], 500e-6,
                        steps)
    config = _full()["config"]
    s.update(examples_per_s=4e5, flops_per_example=dlrm.forward_flops(config),
             work={"embedding": dlrm.embedding_work(
                 config, {"batch": 8192}, 8192 * 214, 1e6)},
             bag_counts={"ids": 8192 * 214, "unique": 10 ** 6})
    return s


def _read(metric, s):
    return spec.metric_reader(metric)(s)


def test_the_dlrm_readers():
    s = _summary()
    assert _read("cross_device_ms.dlrm", s) == pytest.approx(CROSS_MS)
    assert _read("bag_device_ms.dlrm", s) == pytest.approx(BAGS_MS)
    assert _read("step_device_ms.dlrm", s) == _read("step_device_ms.train",
                                                    s)
    assert _read("mfu.dlrm", s) == pytest.approx(
        100 * 3 * 32_060_928 * 4e5 / 67e12)
    bound = sum(trace.bound_s(b, f) for b, f in s["work"]["embedding"])
    assert _read("embedding_roofline.dlrm", s) == pytest.approx(
        100 * bound * K / (K * EMB_US / 1e6))
    # the section readers split the replays as if no unit mark were there
    assert _read("replay_gap_ms.train", s) is not None


@pytest.mark.parametrize("summary", [
    lambda: _summary(drop="recsys_unit_cross_forward_end"),
    lambda: _summary(drop="recsys_unit_bags_backward"),
    lambda: _summary(steps=K + 1),
    lambda: {**_summary(), "device_ops": [
        op for op in _summary()["device_ops"]
        if not op[0].startswith("recsys_unit_")]},
], ids=["a-forward-end-lost", "a-backward-lost", "more-steps",
        "no-unit-marks"])
def test_the_unit_readers_read_nothing_without_whole_stretches(summary):
    s = summary()
    assert (_read("cross_device_ms.dlrm", s) is None
            or _read("bag_device_ms.dlrm", s) is None)


def test_the_roofline_reads_nothing_without_the_counter():
    s = _summary()
    s["work"] = {}
    assert _read("embedding_roofline.dlrm", s) is None
