"""The port's dense-tower primitives against ``recsys_tpu.ops.nn`` on the
same numpy inputs and weights (float32; tolerance 1e-6, a few ulps of the
values' scale, for sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops import nn as jnn
from recsys_tpu_torch.core.checkpoint import flatten
from recsys_tpu_torch.ops import nn as tnn

ATOL = 1e-6


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _mlp(rng, in_dim, dims):
    params = {"layers": []}
    state = {"layers": []}
    d = in_dim
    for h in dims:
        params["layers"].append({
            "dense": {"w": _np(rng, d, h, scale=0.3), "b": _np(rng, h)},
            "bn": {"scale": 1 + _np(rng, h, scale=0.2),
                   "offset": _np(rng, h, scale=0.2)},
        })
        state["layers"].append({"bn": {
            "mean": _np(rng, h, scale=0.5),
            "var": rng.uniform(0.5, 2.0, h).astype(np.float32)}})
        d = h
    return params, state


def test_dense_plain_and_list_form():
    rng = np.random.default_rng(0)
    p = {"w": _np(rng, 12, 5), "b": _np(rng, 5)}
    x = _np(rng, 7, 12)
    ref = np.asarray(jnn.dense(_tree(jnp.asarray, p), jnp.asarray(x),
                               activation=jax.nn.relu))
    tp = _tree(torch.from_numpy, p)
    got = tnn.dense(tp, torch.from_numpy(x), activation=torch.relu)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    pieces = [x[:, :4], x[:, 4:]]
    ref_l = np.asarray(jnn.dense(_tree(jnp.asarray, p),
                                 [jnp.asarray(a) for a in pieces]))
    got_l = tnn.dense(tp, [torch.from_numpy(np.ascontiguousarray(a))
                           for a in pieces])
    np.testing.assert_allclose(got_l.numpy(), ref_l, atol=ATOL, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_tf_semantics(train):
    rng = np.random.default_rng(1)
    p = {"scale": 1 + _np(rng, 6, scale=0.2), "offset": _np(rng, 6)}
    s = {"mean": _np(rng, 6), "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    x = _np(rng, 9, 6, scale=2.0)
    ref_y, ref_s = jnn.batch_norm(_tree(jnp.asarray, p), _tree(jnp.asarray, s),
                                  jnp.asarray(x), train)
    got_y, got_s = tnn.batch_norm(_tree(torch.from_numpy, p),
                                  _tree(torch.from_numpy, s),
                                  torch.from_numpy(x), train)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), atol=ATOL,
                               rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]),
                                   atol=ATOL, rtol=0)


def test_mlp_apply_eval():
    rng = np.random.default_rng(2)
    params, state = _mlp(rng, 10, (8, 6))
    x = _np(rng, 5, 10)
    ref, _ = jnn.mlp_apply(_tree(jnp.asarray, params), _tree(jnp.asarray, state),
                           jnp.asarray(x), train=False, dropout_rate=0.5)
    got, _ = tnn.mlp_apply(_tree(torch.from_numpy, params),
                           _tree(torch.from_numpy, state), torch.from_numpy(x),
                           train=False, dropout_rate=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_dropout_scales_kept_units_and_only_in_training():
    x = torch.ones(2000, 8)
    gen = torch.Generator().manual_seed(0)
    assert tnn.dropout(x, 0.5, False, gen) is x
    y = tnn.dropout(x, 0.25, True, gen)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    with pytest.raises(ValueError):
        tnn.dropout(x, 0.5, True, None)


def test_init_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    p, s = tnn.mlp_init(gen, 10, (8, 6), True, "cpu")
    jp, js = jnn.mlp_init(jax.random.key(0), 10, (8, 6), True)
    flat = lambda t: [(k, tuple(np.shape(v))) for k, v in  # noqa: E731
                      flatten(t)]
    assert flat(p) == flat(_tree(np.asarray, jp))
    assert flat(s) == flat(_tree(np.asarray, js))
    w = p["layers"][0]["dense"]["w"]
    assert w.abs().max() <= (6 / (10 + 8)) ** 0.5
    emb = tnn.embedding_init(gen, (4000, 16), "cpu")
    assert emb.abs().max() <= 2 / 4 + 1e-6
    assert abs(emb.std().item() - 0.88 / 4) < 0.01   # σ of N(0,1) cut at ±2
    meta = tnn.glorot_uniform(gen, (3, 4), "meta")
    assert meta.device.type == "meta" and meta.shape == (3, 4)
