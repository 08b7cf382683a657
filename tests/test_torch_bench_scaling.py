"""``tools/bench_scaling.py`` of the port: the collectives one SPMD step
issues, recorded at ``parallel/collectives.py``'s entry points on a world
of gloo ranks, equal the documented dedup + all-to-all contract (the JAX
package's ``tests/test_bench_scaling.py`` reads the same contract from its
compiled HLO): ids E·cap·4 B int32, rows E·cap·W·4 B float32 forward and
backward, far below the dense [B, F, W] activations; the gradient
all-reduce carries the rank's parameters (its shard of the big table
among them), its BN stats and the loss. Weak scaling runs over 1 and 2
ranks; the analytic model uses the H100's published specifications."""

import numpy as np
import pytest

from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.embeddings.engines import SPLIT_THRESHOLD
from recsys_tpu_torch.embeddings.table import pad_rows
from recsys_tpu_torch.parallel.sharded_embedding import a2a_capacity
from recsys_tpu_torch.tools import bench_scaling as BS

BIG = sum(1 for v in CriteoConfig().field_vocab_sizes if v > SPLIT_THRESHOLD)


def _contract(batch_global: int, data_axis: int, model_axis: int,
              cap_factor: float = 2.0) -> dict:
    n = (batch_global // data_axis) * BIG
    nc = -(-n // model_axis)
    cap = a2a_capacity(nc * model_axis, model_axis, cap_factor, exact=False)
    return {"ids": model_axis * cap * 4, "acts": model_axis * cap * 17 * 4,
            "cap": cap}


def test_collective_sizes_scale_with_unique_ids():
    c2 = BS.collective_sizes(batch=8192, model_axis=2, width=17)
    c4 = BS.collective_sizes(batch=8192, model_axis=4, width=17)
    assert c4["a2a_capacity_ids_per_pair"] < c2["a2a_capacity_ids_per_pair"]
    assert c2["activation_return_bytes_per_device"] < 8192 * 39 * 17 * 4
    assert c2["id_exchange_bytes_per_device"] == \
        2 * c2["a2a_capacity_ids_per_pair"] * 4


@pytest.fixture(scope="module")
def recorded():
    """One SPMD DeepFM step's collectives at global batch 2048 on a 2 x 2
    world and at 1024 on 1 x 4 (gloo ranks, full width)."""
    return {(2, 2): BS.measured_collectives(model_axis=2, data_axis=2,
                                            batch=2048),
            (4, 1): BS.measured_collectives(model_axis=4, data_axis=1,
                                            batch=1024)}


def test_recorded_collectives_match_the_contract(recorded):
    batch, da, ma = 2048, 2, 2
    want = _contract(batch, da, ma)
    got = recorded[(ma, da)]
    a2a = got["all-to-all"]
    ids = [c for c in a2a if c["dtype"] == "int32"]
    assert len(ids) == 1 and ids[0]["bytes"] == want["ids"], (ids, want)
    assert ids[0]["shape"] == (ma, want["cap"])
    acts = [c for c in a2a if c["dtype"] == "float32"
            and c["shape"][-1] == 17]
    assert len(acts) == 2, a2a                    # forward + backward
    assert all(c["bytes"] == want["acts"] for c in acts), (acts, want)
    assert len(a2a) == 3
    dense = (batch // da) * 39 * 17 * 4
    assert all(c["bytes"] < dense for c in acts)
    # the gradient all-reduce over data: every parameter of the rank (its
    # rows of the big table among them), the loss, the BN stats
    (ar,) = got["all-reduce"]
    assert ar["dtype"] == "float32"
    assert ar["shape"] == (got["param_elements"] + 1
                           + got["model_state_elements"],)
    big_rows = pad_rows(sum(v for v in CriteoConfig().field_vocab_sizes
                            if v > SPLIT_THRESHOLD))
    assert got["param_elements"] > big_rows // ma * 17
    # the un-dedup's all-gather, and its transpose
    assert len(got["all-gather"]) == 1
    assert len(got["reduce-scatter"]) == 1


def test_recorded_a2a_shrinks_with_model_axis(recorded):
    """Per (sender, owner) pair the id capacity falls as E grows (cap ∝
    1/E² at a fixed global batch): measured, not the formula."""
    per_pair = {ma: max(c["bytes"] for c in got["all-to-all"]
                        if c["dtype"] == "int32") // ma
                for (ma, _), got in recorded.items()}
    assert per_pair[4] < per_pair[2], per_pair


def test_scaling_model_terms():
    m1 = BS.scaling_model(model_axis=1, n_chips=4)
    m2 = BS.scaling_model(model_axis=2, n_chips=4)
    assert m2["hbm_bytes_per_step"] < m1["hbm_bytes_per_step"]
    assert m2["t_nvlink_ms"] < m1["t_nvlink_ms"]
    assert m1["bound"] in ("hbm", "nvlink", "compute")
    assert "not measured" in m1["assumptions"]
    assert np.isclose(m1["t_hbm_ms"],
                      m1["hbm_bytes_per_step"] / 3.35e12 * 1e3)
    assert m1["predicted_examples_per_s_per_chip"] > 100_000


def test_weak_scaling_one_and_two_ranks():
    result = BS.main(["--devices=1,2", "--batch_per_device=128",
                      "--steps=4"])
    rows = result["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["model_axis"] for r in rows] == [1, 2]
    assert rows[0]["parallel_efficiency"] == 1.0
    assert rows[1]["parallel_efficiency"] > 0.0
    for r in rows:
        assert np.isfinite(r["loss"]) and r["loss"] < 2.0
