"""The port's row-sharded lookups (``parallel/sharded_embedding.py``)
against the JAX package's, on gloo meshes of 2 and 4 CPU processes.

The same table and ids go to the JAX lookup (``shard_map`` over the
pytest process's virtual CPU devices) and to the port's, run by one worker
process per rank (``tests/torch_dist_worker.py``). The a2a forward is a
copy of table rows, so it must be bitwise the JAX forward, the port's psum
oracle and the port's local gather. The table gradient of Σ rows² must
match the local gradient within rtol 1e-6 (sums of the same terms in
another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
from recsys_tpu.core.config import MeshConfig as JaxMeshConfig
from recsys_tpu.core.mesh import make_mesh as jax_make_mesh
from recsys_tpu.parallel import sharded_embedding as JSE
from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.parallel import sharded_embedding as SE

# key: ((data, model), V, W, B, F, exact, cap_factor, ids below)
CASES = {
    "one_member_2x1": ((2, 1), 32, 4, 8, 3, True, 2.0, 32),
    "exact_1x2": ((1, 2), 64, 16, 8, 5, True, 2.0, 64),
    "duplicates_1x2": ((1, 2), 64, 8, 16, 5, False, 2.0, 4),
    "exact_2x2": ((2, 2), 64, 16, 8, 5, True, 2.0, 64),
    "duplicates_2x2": ((2, 2), 64, 8, 16, 5, False, 2.0, 4),
    "ragged_2x2": ((2, 2), 64, 8, 6, 3, True, 2.0, 64),
    "exact_1x4": ((1, 4), 64, 16, 8, 5, True, 2.0, 64),
    "duplicates_1x4": ((1, 4), 64, 8, 16, 5, False, 2.0, 4),
    "ragged_1x4": ((1, 4), 64, 8, 6, 3, True, 2.0, 64),
    "capacity_1x4": ((1, 4), 128, 8, 16, 4, False, 1.5, 128),
}


def _inputs(key):
    (_, _), v, w, b, f, _, _, hi = CASES[key]
    rng = np.random.default_rng(sorted(CASES).index(key))
    table = rng.normal(size=(v, w)).astype(np.float32)
    gids = rng.integers(0, hi, (b, f)).astype(np.int32)
    return table, gids


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{key: {'a2a', 'a2a_grad', 'psum', 'psum_grad'}} of the port, from
    one launch per world size."""
    results = {}
    for world in (2, 4):
        keys = [k for k, c in CASES.items() if c[0][0] * c[0][1] == world]
        io = tmp_path_factory.mktemp(f"lookup{world}")
        arrays = {}
        for k in keys:
            arrays[k + "_table"], arrays[k + "_gids"] = _inputs(k)
        np.savez(io / "in.npz", **arrays)
        (io / "in.json").write_text(json.dumps({"cases": [
            {"key": k, "mesh": list(CASES[k][0]), "exact": CASES[k][5],
             "cap_factor": CASES[k][6]} for k in keys]}))
        out, _ = W.run_cases("lookup", str(io), world)
        for k in keys:
            results[k] = {n: out[f"{k}_{n}"] for n in
                          ("a2a", "a2a_grad", "psum", "psum_grad")}
    return results


def _jax_a2a(key):
    (data, model), *_, exact, cap_factor, _ = CASES[key]
    table, gids = _inputs(key)
    env = jax_make_mesh(JaxMeshConfig(data_axis=data, model_axis=model),
                        jax.devices()[:data * model])
    fn = jax.jit(shard_map(
        lambda tbl, ids: JSE.a2a_embedding_lookup(
            tbl, ids, "model", exact=exact, cap_factor=cap_factor),
        mesh=env.mesh, in_specs=(P("model", None), P("data", None)),
        out_specs=P("data", None, None), check_vma=False))
    return np.asarray(fn(jnp.asarray(table), jnp.asarray(gids)))


def _local(key):
    """The port's single-process gather and the gradient of Σ rows²."""
    table, gids = _inputs(key)
    t = torch.from_numpy(table).requires_grad_()
    rows = emb_table.table_gather(t, torch.from_numpy(gids).long())
    (g,) = torch.autograd.grad((rows ** 2).sum(), t)
    return rows.detach().numpy(), g.numpy()


@pytest.mark.parametrize("key", sorted(CASES))
def test_a2a_forward_is_bitwise_the_jax_lookup(port, key):
    got = port[key]["a2a"]
    rows, _ = _local(key)
    assert got.shape == rows.shape
    np.testing.assert_array_equal(got, _jax_a2a(key))
    np.testing.assert_array_equal(got, port[key]["psum"])
    np.testing.assert_array_equal(got, rows)


@pytest.mark.parametrize("key", sorted(CASES))
@pytest.mark.parametrize("lookup", ["a2a", "psum"])
def test_table_gradient_matches_local(port, key, lookup):
    _, want = _local(key)
    np.testing.assert_allclose(port[key][lookup + "_grad"], want, rtol=1e-6,
                               atol=1e-7)


def test_the_cases_need_what_they_claim():
    """The ragged cases pad their chunks with the sentinel, the duplicate
    cases deduplicate, and the non-exact capacity case is lossless at its
    factor only because `a2a_overflow` says so."""
    for key in ("ragged_2x2", "ragged_1x4"):
        (data, model), _, _, b, f, *_ = CASES[key]
        assert (b // data * f) % model != 0, key
    for key in ("duplicates_1x2", "duplicates_2x2", "duplicates_1x4"):
        _, gids = _inputs(key)
        assert len(np.unique(gids)) * 4 < gids.size, key
    (data, model), v, *_ = CASES["capacity_1x4"]
    _, gids = _inputs("capacity_1x4")
    assert SE.a2a_overflow(gids, model, v // model, 1.5) == 0
    assert SE.a2a_capacity(gids.size, model, 1.5, False) < gids.size // model


@pytest.mark.parametrize("factor", [0.04, 0.25, 0.5, 1.0, 2.0, 4.0])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_a2a_overflow_and_capacity_match_jax(factor, shards):
    rng = np.random.default_rng(7)
    for gids in (rng.integers(0, 64, (8, 5)), np.zeros((8, 5), np.int64),
                 np.arange(48).reshape(8, 6) % 16,
                 rng.integers(0, 64, (7, 3))):
        assert SE.a2a_overflow(gids, shards, 64 // shards, factor) == \
            JSE.a2a_overflow(gids, shards, 64 // shards, factor)
        for exact in (False, True):
            assert SE.a2a_capacity(gids.size, shards, factor, exact) == \
                JSE.a2a_capacity(gids.size, shards, factor, exact)
