"""The benchmark's counts of work: flops an example, bytes and flops of each
kernel launch, the bound, at shapes whose counts are worked out by hand."""

import json
import os

import pytest

from benchmark import spec, trace
from benchmark.models import criteo, deepfm, xdeepfm


def _config(name):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_expected_distinct_ids_at_known_shapes():
    assert criteo.expected_distinct(1, 50, 2.2) == pytest.approx(1.0)
    assert criteo.expected_distinct(1000, 1, 2.2) == pytest.approx(1.0)
    # uniform ids (skew 1) over 4 rows, 2 draws: 4·(1 − (3/4)²)
    assert criteo.expected_distinct(4, 2, 1.0) == pytest.approx(1.75)
    # many draws name every row
    assert criteo.expected_distinct(10, 10**6, 2.2) == pytest.approx(10.0)


def test_embedding_work_at_a_known_shape():
    config = {"cont_boundaries": [[0.0]], "cat_vocabs": [3000],
              "embedding_dim": 2, "split_threshold": 2048}
    traffic = {"batch": 4, "id_skew": 1.0}
    (g_small, s_small, g_big, s_big) = criteo.embedding_work(config, traffic)
    # small table: one field of 2 rows, 4 ids of width 3; 2·(1 − ½⁴) rows
    distinct = 2 * (1 - 0.5 ** 4)
    assert g_small == pytest.approx((4 * 4 + 4 * 3 * (distinct + 4), 0.0))
    assert s_small == pytest.approx((4 * 4 + 4 * 4 * 3 + 4 * 3 * distinct,
                                     4 * 3))
    d_big = criteo.expected_distinct(3000, 4, 1.0)
    assert g_big == pytest.approx((16 + 12 * (d_big + 4), 0.0))
    assert s_big[1] == 12


def test_cin_work_at_a_known_shape():
    # n = 2 rows, F0 = Fk = 3 (the first layer: xk is x0, read once), H = 2
    assert xdeepfm.cin_fwd_work(2, 3, 3, 2) == (4 * (6 + 18 + 2 + 4),
                                               18 + 72 + 8)
    # a later layer reads xk [n, Fk] too
    assert xdeepfm.cin_fwd_work(2, 3, 2, 2)[0] == 4 * (6 + 12 + 2 + 4) + 16
    nbytes, flops = xdeepfm.cin_bwd_work(2, 3, 3, 2)
    assert nbytes == 4 * (2 * (6 + 6 + 18 + 4) + 2)
    assert flops == 2 * 2 * 2 * 9 + 4 * 18 + 18 + 2 * 2 * 9 * 2 + 2 * 2 * 2


def test_model_flops_an_example():
    # DeepFM: 2·(624·100 + 100·100 + 100·1) + 2·(3 + 2·39·16 + 16)
    assert deepfm.forward_flops(_config("deepfm-criteo")) == 147_534
    # xDeepFM: CIN Σ 16·39·Fk·(1 + 2H) over (39, 20), (20, 10), (10, 10),
    # the tower 145,000, and 2·(13 + 40 + 3) for its three small layers
    cin = 16 * 39 * (39 * 41 + 20 * 21 + 10 * 21)
    assert xdeepfm.forward_flops(_config("xdeepfm-criteo")) == \
        cin + 145_000 + 2 * (13 + 40 + 3)


def test_bound_is_the_larger_of_bytes_and_flops():
    p = trace.peaks()
    assert trace.bound_s(p["hbm_bytes_per_s"], 0) == pytest.approx(1.0)
    assert trace.bound_s(1, p["fp32_flops_per_s"] * 2) == pytest.approx(2.0)


def test_criteo_split_is_25_small_and_14_big_fields():
    parts = criteo.engine_parts(_config("deepfm-criteo"))
    assert (len(parts["small"]), len(parts["big"])) == (25, 14)
    assert sum(criteo.field_vocabs(_config("deepfm-criteo"))) == 840_646
