"""xDeepFM in the port against the JAX package: eval-mode logits from the
same parameters (a JAX tree with every leaf replaced by seeded numpy noise,
converted with ``convert.convert_params``) and the same synthetic batch, at
a small config. Tolerance 1e-5: float32 sums taken in another order
through the CIN and the dense layers."""

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import CriteoConfig as JCriteo
from recsys_tpu.core.config import ModelConfig as JModel
from recsys_tpu.data import criteo
from recsys_tpu.models.api import make_model as jmake
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train.train_state import make_predict_step

VOCABS = (50,) * 20 + (3000,) * 6
SMALL = dict(name="xdeepfm", embedding_dim=4, cin_layers=(5, 3),
             deep_layers=(8, 8))


def randomize(tree, seed):
    """Every leaf replaced by seeded noise of its shape, so that every
    weight matters: BN var in [0.5, 2], and the biases of the three
    one-unit branch outputs in [1, 2] so that their ReLUs stay alive."""
    rng = np.random.default_rng(seed)
    alive = ("['lin_dense']['b']", "['cin_out']['b']", "['dnn_out']['b']")

    def leaf(path, a):
        shape, key = np.shape(a), jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if key.endswith(alive):
            return rng.uniform(1.0, 2.0, shape).astype(np.float32)
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("use_bn", [True, False])
def test_xdeepfm_logits_match_jax(use_bn):
    jm = jmake("xdeepfm", JCriteo(cat_vocabs=VOCABS),
               JModel(**SMALL, use_bn=use_bn))
    tm = make_model("xdeepfm", CriteoConfig(cat_vocabs=VOCABS),
                    ModelConfig(**SMALL, use_bn=use_bn))
    jparams, jstate = randomize(jm.init(jax.random.key(0)), 1)
    batch = criteo.synthetic_criteo(37, JCriteo(cat_vocabs=VOCABS))
    ref, _ = jm.apply(jparams, jstate, {"ids": batch["ids"],
                                        "dense": batch["dense"]}, train=False)

    params = convert.convert_params(jparams)
    state = convert.convert_params(jstate)
    tbatch = {"ids": torch.from_numpy(batch["ids"].astype(np.int64)),
              "dense": torch.from_numpy(batch["dense"])}
    with torch.inference_mode():
        got, _ = tm.apply(params, state, tbatch, train=False)
        probs = make_predict_step(tm)(params, state, tbatch)
    assert got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.sigmoid(ref)),
                               atol=1e-5, rtol=0)
    # rows differ: the three branches are alive and the check means something
    assert float(np.std(np.asarray(ref))) > 0.01


def test_port_init_has_the_jax_tree_layout():
    jm = jmake("xdeepfm", JCriteo(cat_vocabs=VOCABS), JModel(**SMALL))
    tm = make_model("xdeepfm", CriteoConfig(cat_vocabs=VOCABS),
                    ModelConfig(**SMALL))
    j = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    t = convert.export_params(tm.init(torch.Generator().manual_seed(0), "cpu"))
    jl = jax.tree_util.tree_flatten_with_path(j)[0]
    tl = jax.tree_util.tree_flatten_with_path(t)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype, \
            jax.tree_util.keystr(p)
