"""The port's SplitEngine inference lookup against the JAX engine's, from
the same (converted) tables and ids. Both are gathers and float32 sums
taken in another order (the JAX engine sums fields by a matmul), so the
tolerance is 1e-6 absolute and relative."""

import jax
import numpy as np
import pytest
import torch

from recsys_tpu.core.config import EmbeddingConfig as JEmbeddingConfig
from recsys_tpu.embeddings import engines as jengines
from recsys_tpu.embeddings import table as jtable
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.config import EmbeddingConfig
from recsys_tpu_torch.embeddings import engines, table

VOCABS = (7, 40, 3000, 11, 2500, 60)


@pytest.mark.parametrize("vocabs", [VOCABS, (9, 30), (3000, 2100)])
def test_lookup_parts_match(vocabs):
    d = 4
    jeng = jengines.SplitEngine(JEmbeddingConfig(vocabs, d))
    teng = engines.SplitEngine(EmbeddingConfig(vocabs, d))
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        jeng.init(jax.random.key(0)))
    ids = np.stack([rng.integers(0, v, 33) for v in vocabs], 1).astype(np.int32)

    ref = jeng.lookup_parts(jparams, ids, train=False)
    got = teng.lookup_parts(convert.convert_params(jparams),
                            torch.from_numpy(ids.astype(np.int64)))
    np.testing.assert_array_equal(got.field_order, ref.field_order)
    np.testing.assert_array_equal(teng.field_order, jeng.field_order)
    for name in ("emb_2d", "wide", "emb_sum", "emb_sq_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert len(got.emb_parts) == len(ref.emb_parts)
    for g, r in zip(got.emb_parts, ref.emb_parts):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got.emb_3d(len(vocabs), d).numpy(),
        np.asarray(ref.emb_3d(len(vocabs), d)), atol=1e-6, rtol=0)


def test_table_shapes_match_jax():
    cfg = EmbeddingConfig(VOCABS, 4)
    assert table.pad_rows(cfg.total_vocab) == jtable.pad_rows(cfg.total_vocab)
    np.testing.assert_array_equal(table.field_offsets(VOCABS),
                                  jtable.field_offsets(VOCABS))
    tp = engines.SplitEngine(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jp = jengines.SplitEngine(JEmbeddingConfig(VOCABS, 4)).init(
        jax.random.key(0))
    assert tuple(tp["small"].shape) == jp["small"].shape
    assert tuple(tp["big"].shape) == jp["big_wm"].shape[::-1]
    assert tp["b"].shape == jp["b"].shape == ()


def test_training_lookup_not_ported():
    eng = engines.SplitEngine(EmbeddingConfig(VOCABS, 4))
    params = eng.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError):
        eng.lookup_parts(params, torch.zeros((2, len(VOCABS)), dtype=torch.long),
                         train=True)
