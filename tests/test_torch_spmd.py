"""The port's SPMD step (``parallel/spmd.py``) on gloo meshes of 4 CPU
processes (4×1, 2×2, 1×4), against the port's local step and the JAX
package's SPMD step (mirroring ``tests/test_spmd.py``).

One launch of 4 worker processes (``tests/torch_dist_worker.py``) runs
every case; the local step runs here, and the JAX step on the pytest
process's virtual CPU devices. A 16-vocab split threshold puts the
40-vocab categorical fields on the sharded exchange and the continuous
buckets on the small table, whole on every rank.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from recsys_tpu.core.config import CriteoConfig as JaxCriteoConfig
from recsys_tpu.core.config import MeshConfig as JaxMeshConfig
from recsys_tpu.core.config import ModelConfig as JaxModelConfig
from recsys_tpu.core.mesh import make_mesh as jax_make_mesh
from recsys_tpu.data import criteo as jax_criteo
from recsys_tpu.models.api import make_model as jax_make_model
from recsys_tpu.parallel import spmd as jax_spmd
from recsys_tpu.train import optim as jax_optim
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import train_state as TS

SMALL = JaxCriteoConfig(cat_vocabs=tuple([40] * 26))
BSZ = 32
LR = {"fm": 1e-2, "wide": 0.5}

# key: (model, engine, (data, model axis), what, batch seed, from JAX)
CASES = {
    **{f"step_{e}_{m}": ("fm", e, (4 // m, m), "step", 0, False)
       for e in ("fused", "split") for m in (1, 2, 4)},
    **{f"grads_{m}": ("fm", "split", (4 // m, m), "grads", 3, False)
       for m in (2, 4)},
    **{f"wide_{m}": ("wide", "split", (4 // m, m), "step", 0, False)
       for m in (2, 4)},
    **{f"engine_{e}_{m}": ("fm", e, (4 // m, m), "engine", 0, True)
       for e in ("fused", "split") for m in (2, 4)},
    "jax_fm_2x2": ("fm", "split", (2, 2), "step", 0, True),
    "jax_wide_2x2": ("wide", "split", (2, 2), "step", 0, True),
}


def _batch(seed):
    return jax_criteo.synthetic_criteo(
        BSZ, SMALL, jax_criteo.SyntheticSpec(seed=seed))


def _jax_model(name):
    return jax_make_model(name, SMALL, JaxModelConfig(
        name=name, embedding_dim=8, dropout=0.0, emb_engine="split",
        split_threshold=16))


def _jax_spmd_step(name):
    """(initial state, loss, state after one step) of the JAX SPMD step on
    a 2×2 mesh, as numpy trees (params, model_state, opt_state)."""
    model = _jax_model(name)
    env = jax_make_mesh(JaxMeshConfig(data_axis=2, model_axis=2),
                        jax.devices()[:4])
    opt = jax_optim.for_model(model.meta, LR[name])
    state = jax_spmd.create_spmd_state(model, env, seed=0, opt=opt)
    first = jax.device_get((state.params, state.model_state,
                            state.opt_state))
    host = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    step = jax_spmd.make_spmd_train_step(model, opt, env, BSZ, host,
                                         a2a_exact=True)
    new, loss = step(state, jax_spmd.place(host, jax_spmd.batch_specs(host),
                                           env))
    return first, float(loss), jax.device_get(
        (new.params, new.model_state, new.opt_state))


def _jax_engine_lookup(engine, env):
    """(whole engine params, emb, wide) of the JAX engine's sharded lookup
    (``shard_map``, exact capacity) of batch 0's ids."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from recsys_tpu.embeddings import engines

    eng = engines.make_engine(_jax_model("fm").meta["engine"].cfg, engine,
                              threshold=16)
    params = eng.init(jax.random.key(1))
    fn = jax.jit(shard_map(
        lambda p, ids: eng.lookup_sharded(p, ids, "model", exact=True),
        mesh=env.mesh, in_specs=(jax_spmd.param_specs(params),
                                 P("data", None)),
        out_specs=(P("data", None, None), P("data", None)),
        check_vma=False))
    emb, wide = fn(params, jnp.asarray(_batch(0)["ids"]))
    return jax.device_get(params), np.asarray(emb), np.asarray(wide)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(port outputs, JAX results) with every case run in one launch."""
    io = tmp_path_factory.mktemp("spmd")
    arrays = {f"b{s}_{k}": v for s in (0, 3) for k, v in _batch(s).items()}
    jax_runs, cases = {}, []
    for key, (name, engine, mesh, what, seed, from_jax) in CASES.items():
        case = {"key": key, "model": name, "engine": engine,
                "mesh": list(mesh), "what": what, "batch": f"b{seed}",
                "lr": LR[name]}
        if what == "engine":
            jax_runs[key] = _jax_engine_lookup(engine, _jax_mesh(mesh))
            arrays.update({f"{key}_p_{k}": np.asarray(v) for k, v in
                           jax_runs[key][0].items()})
        elif from_jax:
            first, loss, after = jax_runs[key] = _jax_spmd_step(name)
            CheckpointManager(str(io / key)).save(0, first)
            case["ckpt"] = str(io / key)
        cases.append(case)
    np.savez(io / "in.npz", **arrays)
    (io / "in.json").write_text(json.dumps({"cases": cases}))
    out, counts = W.run_cases("spmd", str(io), 4)
    port = {k: ((out[f"{k}_emb"], out[f"{k}_wide"]) if k.startswith("engine")
                else (float(out[f"{k}_loss"]),
                      [out[f"{k}_leaf{i}"] for i in range(counts[k])]))
            for k in CASES}
    return port, jax_runs


MESHES = {}


def _jax_mesh(mesh):
    if mesh not in MESHES:
        MESHES[mesh] = jax_make_mesh(
            JaxMeshConfig(data_axis=mesh[0], model_axis=mesh[1]),
            jax.devices()[:mesh[0] * mesh[1]])
    return MESHES[mesh]


def _local(name, engine, seed, params=None):
    """(loss, whole state after one local step, pre-optimizer grads) of
    the port's single-process path from the seed-0 state (or from the JAX
    tree ``params``), in the JAX layout."""
    model, opt = W._small_model(name, engine, LR[name])
    ts, _ = TS.create_train_state(model, 0, LR[name], "cpu", opt)
    if params is not None:
        ts = convert.convert_train_state((*params, 0, np.zeros(2, np.uint32)))
    batch = fast.stage_dataset(_batch(seed), "cpu")
    loss, _, grads = TS.loss_and_grads(model, ts.params, ts.model_state,
                                       batch)
    ts, _ = TS.make_train_step(model, opt)(ts, batch)
    whole = convert.export_params((ts.params, ts.model_state, ts.opt_state))
    return float(loss), whole, [g.numpy() for g in tree_util.leaves(grads)]


def _assert_adam_step_close(got, want):
    """tests/test_spmd.py's tolerance for parameters after one Adam step:
    rows whose gradient terms nearly cancel can step differently by up to
    ~lr, since the first Adam step behaves like sign(g)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-3, rtol=1.0)
        assert np.mean(np.abs(g - w)) < 2e-4


@pytest.mark.parametrize("key", [k for k in CASES if k.startswith("engine")])
def test_engine_lookup_sharded_matches_jax(run, key):
    """Each engine's ``lookup_parts_sharded`` over the exchange from the
    same (converted) JAX parameters, in the original field order: the rows
    the JAX engine's ``lookup_sharded`` gives (the JAX split engine reads
    its small table by a one-hot matmul, exact in float32)."""
    emb, wide = run[0][key]
    _, jax_emb, jax_wide = run[1][key]
    np.testing.assert_allclose(emb, jax_emb, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wide, jax_wide, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("key", [k for k in CASES if k.startswith("step")])
def test_spmd_step_matches_local(run, key):
    name, engine, _, _, seed, _ = CASES[key]
    loss, leaves = run[0][key]
    ref_loss, whole, _ = _local(name, engine, seed)
    assert abs(loss - ref_loss) < 1e-4
    n = len(tree_util.leaves(whole[0]))
    _assert_adam_step_close(leaves[:n], tree_util.leaves(whole[0]))


@pytest.mark.parametrize("key", ["grads_2", "grads_4"])
def test_spmd_grads_match_local_exactly(run, key):
    """Pre-optimizer gradients: summed over data, the split leaves'
    normalized by the model axis (`normalize_model_replication`). Without
    the normalization the tables' gradients would be E× the local ones."""
    name, engine, _, _, seed, _ = CASES[key]
    _, got = run[0][key]
    _, _, want = _local(name, engine, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("key", ["wide_2", "wide_4"])
def test_spmd_wide_ftrl_step_matches_local(run, key):
    """FTRL is not scale invariant: a gradient off by the model axis'
    size would move the weights by another amount."""
    loss, leaves = run[0][key]
    ref_loss, whole, _ = _local("wide", "split", 0)
    assert abs(loss - ref_loss) < 1e-6
    want = tree_util.leaves(whole)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["fm", "wide"])
def test_spmd_step_from_jax_params_matches_jax_spmd_step(run, name):
    key = f"jax_{name}_2x2"
    loss, leaves = run[0][key]
    first, jax_loss, after = run[1][key]
    assert abs(loss - jax_loss) < 1e-5
    want = [np.asarray(x) for x in tree_util.leaves(after)]
    n = len(tree_util.leaves(after[0]))
    if name == "fm":
        _assert_adam_step_close(leaves[:n], want[:n])
    else:
        for g, w in zip(leaves, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    # the port's local step from the same converted parameters agrees too
    ref_loss, _, _ = _local(name, "split", 0, params=first)
    assert abs(loss - ref_loss) < 1e-5
