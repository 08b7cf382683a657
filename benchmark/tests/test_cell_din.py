"""The DIN cell on the CPU at a tiny size (vocabularies of a few hundred,
histories of 16, batch 32): a whole run comes out correct against the plain
reference (``benchmark/models/din.py``), faults planted in the port make it
not correct, and the TF32 control fails a number the port passes; the
generator's set, its law worked out on the host, the counts of work, and
the readers of the cell's five per-layer metrics on summaries made by
hand."""

import json
import os

import pytest
import torch

from benchmark import control, din_data, run, spec, trace
from benchmark.models import criteo, din
from recsys_tpu_torch.ops import interactions, segment_sum

CELL = "din-movielens.train-b1024-p128"
TINY = {"item_vocab": 300, "cate_vocab": 13, "max_hist": 16}


def _full():
    return spec.load_cell(CELL)


@pytest.fixture
def din_cell(tmp_path):
    """A tiny DIN cell of its own checkout in ``tmp_path``, with the full
    cell's limits."""
    torch.set_num_threads(2)
    here = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (here / d).mkdir(parents=True)
    full = _full()
    config = dict(full["config"], name="din-tiny", **TINY)
    traffic = dict(full["traffic"], users=120, ratings_median=10,
                   ratings_min=2, ratings_max=60, categories=12, batch=32,
                   steps_per_call=2)
    name = "din-tiny.train-b32"
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "din-tiny", "source": "test",
                             "file": "benchmark/configs/din-tiny.json",
                             "reduced": sorted(TINY), "why": "test"})
    bench["workloads"].append({"name": name, "config": "din-tiny",
                               "traffic": "tiny-din", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    for path, obj in ((tmp_path / "BENCHMARK.json", bench),
                      (here / "configs" / "din-tiny.json", config),
                      (here / "traffic" / "tiny-din.json", traffic),
                      (here / "limits" / f"{name}.json", full["limits"])):
        path.write_text(json.dumps(obj))
    return spec.load_cell(name, str(tmp_path))


def _run(cell, seed=2 ** 31 + 77):
    return run.run_cell(cell, seed, 0.1, False, torch.device("cpu"))


def test_a_tiny_din_cell_is_correct_on_the_cpu(din_cell):
    result = _run(din_cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert {"grad_gap.tables", "grad_gap.attention",
            "change_gap.whole"} <= set(result["checks"])


def _padding_ignored(monkeypatch):
    real = interactions.din_attention

    def fault(params, hist_emb, hist_ids, query_emb, **kw):
        return real(params, hist_emb, torch.ones_like(hist_ids), query_emb,
                    **kw)

    monkeypatch.setattr(interactions, "din_attention", fault)


def _product_dropped(monkeypatch):
    """The units' input is [hist, query, 0, hist − query]."""
    real_cat = torch.cat

    def fault(params, hist_emb, hist_ids, query_emb, **kw):
        def cat(parts, dim=0):
            if len(parts) == 4:
                parts = [parts[0], parts[1], torch.zeros_like(parts[2]),
                         parts[3]]
            return real_cat(parts, dim=dim)

        torch.cat = cat
        try:
            return real(params, hist_emb, hist_ids, query_emb, **kw)
        finally:
            torch.cat = real_cat

    real = interactions.din_attention
    monkeypatch.setattr(interactions, "din_attention", fault)


def _item_table_sum_doubled(monkeypatch):
    """K2 hands back twice the item table's gradient; the other tables'
    (the category table's, the bias's [V, 1]) are right."""
    real = segment_sum.segment_sum

    def fault(ids, grads, num_rows):
        out = real(ids, grads, num_rows)
        wide = num_rows == TINY["item_vocab"] and grads.shape[1] > 1
        return 2.0 * out if wide else out

    monkeypatch.setattr(segment_sum, "segment_sum", fault)


def _category_unit_skipped(monkeypatch):
    """The second unit of each forward, the category's, gives zeros."""
    real = interactions.din_attention
    calls = [0]

    def fault(*args, **kw):
        out = real(*args, **kw)
        calls[0] += 1
        return torch.zeros_like(out) if calls[0] % 2 == 0 else out

    monkeypatch.setattr(interactions, "din_attention", fault)


@pytest.mark.parametrize("fault", [_padding_ignored, _product_dropped,
                                   _item_table_sum_doubled,
                                   _category_unit_skipped])
def test_a_fault_in_the_port_is_not_correct(din_cell, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(din_cell)
    assert not result["correct"], result["checks"]


def test_the_control_fails_where_the_port_passes(din_cell):
    names = [k for k in din_cell["limits"] if not k.startswith("_")]
    for seed in (3, 4):
        r = control.readings(din_cell, seed, torch.device("cpu"))
        limit = {k: din_cell["limits"][k]["limit"] for k in names}
        assert all(r["program"][k] <= limit[k] for k in names)
        assert any(r["control"][k] > limit[k] for k in names)
        assert any(r["half_batch"][k] > limit[k] for k in names)


# ------------------------------------------------------------------- the set

def test_the_same_seed_makes_the_same_set(din_cell):
    config, traffic = din_cell["config"], din_cell["traffic"]
    big = 2 ** 31 + 12_345
    a = din_data.make_dataset(config, traffic, big, "cpu")
    b = din_data.make_dataset(config, traffic, big, "cpu")
    c = din_data.make_dataset(config, traffic, big + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["label"].shape != c["label"].shape or \
        not torch.equal(a["hist_iid"], c["hist_iid"])


def test_ids_are_in_range_and_zero_only_pads(din_cell):
    config, traffic = din_cell["config"], din_cell["traffic"]
    d = din_data.make_dataset(config, traffic, 7, "cpu")
    p, v = config["max_hist"], config["item_vocab"]
    assert d["hist_iid"].dtype == torch.int64
    assert d["hist_iid"].shape == (d["label"].shape[0], p)
    assert int(d["i_id"].min()) >= 1 and int(d["i_id"].max()) < v
    assert int(d["i_cate"].min()) >= 1
    assert int(d["hist_cate"].max()) <= traffic["categories"]
    real = d["hist_iid"] != 0
    assert torch.equal(real, d["hist_cate"] != 0)
    # left-aligned: a real position is never after a pad
    assert torch.equal(real, real.cummin(dim=1).values)
    assert 0.25 < float(d["label"].mean()) < 0.75
    # a history is the user's earlier items: row r+1's ends in row r's item
    short = (real.sum(dim=1) < p)[1:] & real[1:, 0]
    lengths = real.sum(dim=1)
    r = int(torch.nonzero(short & (lengths[1:] > 1))[0]) + 1
    assert int(d["hist_iid"][r, lengths[r] - 1]) == int(d["i_id"][r - 1])


def test_the_law_gives_movielens_rows_and_padding_on_the_host():
    full = _full()
    law = din_data.expected_law(full["config"], full["traffic"])
    assert law["rows"] == pytest.approx(14_470_000, rel=0.01)
    assert law["padding"] == pytest.approx(0.32, abs=0.02)
    assert law["capped"] == pytest.approx(0.48, abs=0.02)


# ------------------------------------------------------------------- work

def test_forward_flops_and_attention_work_by_hand():
    config = _full()["config"]
    unit = 128 * 80 + 80 * 40 + 40                      # MACs a position
    mlp = 96 * 100 + 100 * 50 + 50 * 20 + 20
    assert din.forward_flops(config) == 2 * (2 * 128 * unit + mlp)
    assert 2 * 128 * 2 * unit == 6_901_760
    small = {"embedding_dim": 2, "attention_layers": [3], "max_hist": 4}
    nbytes, flops = din.attention_work(small, {"batch": 5})
    macs = 8 * 3 + 3                                     # 4D → 3 → 1
    assert flops == 2 * 3 * 2 * 5 * 4 * macs
    weights = 8 * 3 + 3 + 3 * 1 + 1
    assert nbytes == 2 * (4 * (2 * 5 * 4 * 2 + 4 * 5 * 2 + 2 * weights)
                          + 8 * 5 * 4)
    full_bytes, full_flops = din.attention_work(config, {"batch": 1024})
    bound = trace.bound_s(full_bytes, full_flops)
    assert bound == pytest.approx(full_flops / 67e12)
    assert bound * 1e3 == pytest.approx(0.316, abs=0.001)


def test_pack_fills_every_leaf_of_the_ports_tree():
    from benchmark import port, port_din

    config = dict(_full()["config"], **TINY)
    template, _ = port.templates(port_din.model(config))
    weights = criteo.make_weights(din.spec(config),
                                  torch.Generator().manual_seed(1), "cpu")
    packed = din.pack(config, weights, template)
    assert torch.equal(packed["att_cate"]["mlp"][1]["w"],
                       weights["units"]["cate"]["hidden"][1]["w"])
    assert torch.equal(packed["mlp"]["layers"][2]["dense"]["b"],
                       weights["mlp"][2]["b"])
    groups = {k.split("/")[0] for k in din.leaf_norms(packed)}
    assert groups == {"tables", "attention", "top"}


# ------------------------------------------------------------------ readers

K = 2
#: one replay from its start (µs); marks take 1 µs
REPLAY = [("recsys_mark_begin", 0, 1), ("gather", 1, 3),
          ("recsys_mark_forward", 3, 4),
          ("recsys_unit_attention_forward", 4, 5),
          ("gemm", 5, 25), ("where", 27, 30),            # a 2 µs gap
          ("recsys_unit_attention_forward_end", 30, 31),
          ("mlp", 31, 35), ("recsys_mark_backward", 35, 36),
          ("mlp_bwd", 36, 40),
          ("recsys_unit_attention_backward", 40, 41),
          ("gemm_bwd", 41, 80),
          ("recsys_unit_attention_backward_end", 80, 81),
          ("segment_chunks", 81, 90), ("recsys_mark_optimizer", 90, 91),
          ("adam", 91, 99), ("recsys_mark_end", 99, 100)]
ATTENTION_MS = (23 + 39) / 1e3


def _summary(drop=None, steps=K):
    """K replays, of a slice of ``steps`` steps; ``drop``: an operation
    the profiler lost in the second replay."""
    device = []
    for i in range(K):
        device += [(n, 200 * i + a, 200 * i + b) for n, a, b in REPLAY
                   if not (i == 1 and n == drop)]
    s = trace.summarize(device, [("cudaGraphLaunch", 0.0, 1.0)], 500e-6,
                        steps)
    config = _full()["config"]
    s.update(examples_per_s=1e5, flops_per_example=din.forward_flops(config),
             work=din.kernel_work(config, {"batch": 1024}),
             attention_counts={"rows": 1000, "real": 685})
    return s


def _read(metric, s):
    return spec.metric_reader(metric)(s)


def test_the_din_readers():
    s = _summary()
    assert _read("attention_device_ms.din", s) == pytest.approx(ATTENTION_MS)
    bound = trace.bound_s(*din.kernel_work(_full()["config"],
                                           {"batch": 1024})["attention"][0])
    assert _read("attention_roofline.din", s) == pytest.approx(
        100 * bound / (ATTENTION_MS / 1e3))
    assert _read("attention_fill.din", s) == pytest.approx(68.5)
    assert _read("step_device_ms.din", s) == _read("step_device_ms.train", s)
    assert _read("mfu.din", s) == pytest.approx(
        100 * 3 * s["flops_per_example"] * 1e5 / 67e12)
    # the section readers split the replays as if no unit mark were there
    assert _read("replay_gap_ms.train", s) is not None


@pytest.mark.parametrize("summary", [
    lambda: _summary(drop="recsys_unit_attention_forward_end"),
    lambda: _summary(drop="recsys_unit_attention_backward"),
    lambda: _summary(steps=K + 1),
    lambda: {**_summary(), "device_ops": [
        op for op in _summary()["device_ops"]
        if not op[0].startswith("recsys_unit_")]},
], ids=["a-forward-end-lost", "a-backward-lost", "more-steps",
        "no-unit-marks"])
def test_the_attention_readers_read_nothing_without_whole_stretches(summary):
    s = summary()
    assert _read("attention_device_ms.din", s) is None
    assert _read("attention_roofline.din", s) is None


def test_the_fill_reads_nothing_without_the_counter():
    s = _summary()
    del s["attention_counts"]
    assert _read("attention_fill.din", s) is None
