"""The benchmark's dataset generator: the same set for the same seed, ids in
range and skewed as the traffic states."""

import torch

from benchmark import data, spec
from benchmark.models import criteo


def _cell(tiny_cell):
    return tiny_cell("deepfm", rows=20_000)


def test_the_same_seed_makes_the_same_set(tiny_cell):
    cell = _cell(tiny_cell)
    big = 2 ** 31 + 12_345
    a = data.make_dataset(cell["config"], cell["traffic"], big, "cpu")
    b = data.make_dataset(cell["config"], cell["traffic"], big, "cpu")
    c = data.make_dataset(cell["config"], cell["traffic"], big + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["ids"], c["ids"])


def test_types_ranges_and_skew(tiny_cell):
    cell = _cell(tiny_cell)
    d = data.make_dataset(cell["config"], cell["traffic"], 7, "cpu")
    vocabs = torch.tensor(criteo.field_vocabs(cell["config"]))
    assert d["ids"].dtype == torch.int64 and d["ids"].shape == (20_000, 39)
    assert d["dense"].dtype == torch.float32 and d["dense"].shape[1] == 13
    assert set(d["label"].unique().tolist()) == {0.0, 1.0}
    assert bool(((d["ids"] >= 0) & (d["ids"] < vocabs)).all())
    # P(id < vocab/10) = 0.1^(1/2.2) ≈ 0.351 for a field of 3,000 rows
    f = criteo.field_vocabs(cell["config"]).index(3000)
    share = float((d["ids"][:, f] < 300).double().mean())
    assert abs(share - 0.1 ** (1 / 2.2)) < 0.02
    # the planted model's labels: positives well below half, as in Criteo
    assert 0.1 < float(d["label"].mean()) < 0.5


def test_the_full_traffic_holds_criteos_rows():
    for name in ("train-b16384", "train-b4096", "train-b1024"):
        cell = spec.load_cell({"train-b16384": "deepfm-criteo.train-b16384",
                               "train-b4096": "xdeepfm-criteo.train-b4096",
                               "train-b1024": "deepfm-criteo.train-b1024"}[name])
        assert cell["traffic"]["rows"] == 45_840_617
