"""The port's config and data modules against the JAX package's: the same
configs, the same synthetic requests for the same seed, the same hashes."""

import dataclasses

import numpy as np
import pytest

from recsys_tpu.core import config as jcfg
from recsys_tpu.data import criteo as jcriteo
from recsys_tpu.data import hashing as jhashing
from recsys_tpu_torch.core import config as tcfg
from recsys_tpu_torch.data import criteo as tcriteo
from recsys_tpu_torch.data import hashing as thashing


@pytest.mark.parametrize("name", ["CriteoConfig", "ModelConfig",
                                  "TrainConfig", "MeshConfig", "RunConfig"])
def test_config_defaults_match(name):
    assert (dataclasses.asdict(getattr(tcfg, name)())
            == dataclasses.asdict(getattr(jcfg, name)()))


def test_criteo_schema_matches():
    t, j = tcfg.CriteoConfig(), jcfg.CriteoConfig()
    assert t.field_vocab_sizes == j.field_vocab_sizes
    assert len(t.field_vocab_sizes) == 39
    assert sum(v <= 2048 for v in t.field_vocab_sizes) == 25


def test_overrides_match():
    ov = ["--model.name=xdeepfm", "--model.cin_layers=8,4",
          "--train.batch_size=64", "--model.use_bn=false"]
    t = tcfg.apply_overrides(tcfg.RunConfig(), ov)
    j = jcfg.apply_overrides(jcfg.RunConfig(), ov)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("start_row", [0, 300])
def test_synthetic_criteo_identical(start_row):
    cfg_t = tcfg.CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    cfg_j = jcfg.CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    t = tcriteo.synthetic_criteo(257, cfg_t, start_row=start_row)
    j = jcriteo.synthetic_criteo(257, cfg_j, start_row=start_row)
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_feature_transforms_identical():
    rng = np.random.default_rng(0)
    cont = rng.lognormal(0.0, 2.0, (64, 13)).astype(np.float32)
    cont[::7, 3] = -1.0
    cfg_t, cfg_j = tcfg.CriteoConfig(), jcfg.CriteoConfig()
    np.testing.assert_array_equal(tcriteo.log_transform(cont, cfg_t),
                                  jcriteo.log_transform(cont, cfg_j))
    np.testing.assert_array_equal(tcriteo.bucketize_cont(cont, cfg_t),
                                  jcriteo.bucketize_cont(cont, cfg_j))
    cat = np.array([[f"{i * 7919 + j:08x}" if (i + j) % 5 else ""
                     for j in range(26)] for i in range(16)], dtype=object)
    np.testing.assert_array_equal(tcriteo.hash_cat(cat, cfg_t),
                                  jcriteo.hash_cat(cat, cfg_j))
    vals = np.arange(-5, 500, 7)
    np.testing.assert_array_equal(thashing.hash_int_bucket(vals, 97),
                                  jhashing.hash_int_bucket(vals, 97))
