"""The JAX package's random draws and initial weights rebuilt in numpy
(`core/jax_prng.py`, `models/jax_init.py`), against JAX itself: keys,
splits, fold-ins and random bits bitwise; uniforms within 2 float32 ulps
of their range (XLA may fuse the scale and shift); normals and truncated
normals within 1e-6 absolute plus 1e-6 relative (``erfinv`` in float64
here, XLA's float32 polynomial there, steep near ±1); every initial leaf of the six Criteo models within 1e-6, with the
tree's structure equal, at two seeds; and the convergence protocol's
initial state equal to the JAX run's."""

import jax
import numpy as np
import pytest

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu.train import train_state as JTS
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import jax_prng as R
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models import jax_init
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.tools import converge
from recsys_tpu_torch.train import optim

VOCABS = (200,) * 20 + (3000,) * 6
EPS = float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3])
def test_keys_splits_fold_ins_and_bits_are_bitwise_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(R.key(seed), jax.random.key_data(k))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(
            R.split(R.key(seed), n),
            jax.random.key_data(jax.random.split(k, n)))
    np.testing.assert_array_equal(R.fold_in(R.key(seed), 7),
                                  jax.random.key_data(jax.random.fold_in(k,
                                                                         7)))
    for shape in ((5,), (33, 17), (4, 3, 2)):
        np.testing.assert_array_equal(
            R.random_bits(R.key(seed), shape),
            np.asarray(jax.random.bits(k, shape, np.uint32)))


def test_samplers_match_jax():
    k = jax.random.key(11)
    lo, hi = -0.3, 0.7
    got = R.uniform(R.key(11), (1000,), lo, hi)
    want = np.asarray(jax.random.uniform(k, (1000,), np.float32, lo, hi))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * EPS * (hi - lo))
    np.testing.assert_allclose(R.normal(R.key(11), (1000,)),
                               np.asarray(jax.random.normal(k, (1000,))),
                               rtol=1e-6, atol=1e-6)
    tn = R.truncated_normal(R.key(11), -2.0, 2.0, (64, 16))
    np.testing.assert_allclose(
        tn, np.asarray(jax.random.truncated_normal(k, -2.0, 2.0, (64, 16))),
        rtol=1e-6, atol=1e-6)
    assert np.abs(tn).max() < 2.0


@pytest.mark.parametrize("name", jax_init.MODELS)
@pytest.mark.parametrize("seed", [0, 3])
def test_initial_weights_are_the_jax_packages(name, seed):
    jts, _ = JTS.create_train_state(
        jmake(name, JCriteo(cat_vocabs=VOCABS), JModel(name=name)),
        seed=seed, learning_rate=1e-3)
    want = jax.tree_util.tree_flatten_with_path(
        (jax.tree.map(np.asarray, jts.params),
         jax.tree.map(np.asarray, jts.model_state)))[0]
    got = jax.tree_util.tree_flatten_with_path(jax_init.init_params(
        name, CriteoConfig(cat_vocabs=VOCABS), ModelConfig(name=name),
        seed))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(p))


def test_init_params_refuses_what_it_does_not_replay():
    with pytest.raises(ValueError, match="not one of"):
        jax_init.init_params("din", CriteoConfig(), ModelConfig(), 0)
    with pytest.raises(ValueError, match="engine"):
        jax_init.init_params("fm", CriteoConfig(),
                             ModelConfig(name="fm", emb_engine="fused"), 0)


def test_the_protocols_initial_state():
    """``converge.initial_state``: the JAX run's weights of the seed."""
    cfg = CriteoConfig(cat_vocabs=VOCABS)
    mcfg = ModelConfig(name="fm")
    model = make_model("fm", cfg, mcfg)
    ts, tx = converge.initial_state(model, mcfg, cfg, optim.adam(1e-3), 0,
                                    "cpu")
    jts, _ = JTS.create_train_state(
        jmake("fm", JCriteo(cat_vocabs=VOCABS), JModel(name="fm")), seed=0,
        learning_rate=1e-3)
    got = convert.export_params(ts.params)
    want = jax.tree.map(np.asarray, jts.params)
    for path in (("final", "w"), ("tables", "small"), ("tables", "big_wm")):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=str(path))
    assert int(ts.step) == 0 and ts.seed == 0
    assert all(float(m.abs().max()) == 0 for m in ts.opt_state.mu.values()
               if hasattr(m, "abs"))

