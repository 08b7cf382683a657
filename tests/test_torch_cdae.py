"""CDAE in the port against the JAX package at a small size (80 items, 150
users, hidden 16, batch 32), from one converted JAX tree on the same numpy
inputs: ``apply`` in eval mode and in train mode with the port's dropout
mask fed to the JAX model's pieces, the loss and every gradient (1e-5 on
values, 2e-6 absolute + 1e-4 relative on gradients: float32 sums of the
same terms in another order), one Adam step (2e-5: a step moves a weight
by about lr), ``predict_topn`` (the same items in the same order: numpy
ranks both), and ``train_cdae`` learning as the JAX test asks of the JAX model
(``tests/test_cf_models.py::test_cdae_end_to_end``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.data import movielens as JML
from recsys_tpu.models import cdae as JC
from recsys_tpu.ops import nn as jnn
from recsys_tpu.train import optim as joptim
from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.data import movielens as ML
from recsys_tpu_torch.models import cdae as C
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim
from test_torch_train import GRAD_TOL, _assert_trees_close

USERS, ITEMS, HIDDEN, B = 150, 80, 16, 32
L2, DROP = 0.01, 0.5


def _models():
    return (JC.make_cdae(ITEMS, USERS + 1, HIDDEN, DROP, L2),
            C.make_cdae(ITEMS, USERS + 1, HIDDEN, DROP, L2))


def _jax_tree(seed=0):
    """JAX's initial tree with seeded noise in the zero-initialized biases,
    so that every leaf matters."""
    (jinit, _, _), _ = _models()
    tree = jax.tree.map(np.asarray, jinit(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for part in ("enc", "dec"):
        tree[part]["b"] = (0.1 * rng.standard_normal(
            tree[part]["b"].shape)).astype(np.float32)
    return tree


def _batch(seed=0):
    users, train_x, _, _ = JML.synthetic_ml100k(USERS, ITEMS, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.choice(USERS, B, replace=False)
    return train_x[idx], users[idx]


def test_init_has_the_jax_trees_structure():
    (jinit, _, _), (init, _, _) = _models()
    got = convert.export_params(init(torch.Generator().manual_seed(0), "cpu"))
    want = jax.tree.map(np.asarray, jinit(jax.random.key(0)))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert got["user_emb"].shape == (USERS + 1, HIDDEN)
    assert not got["enc"]["b"].any() and not got["dec"]["b"].any()


def test_apply_matches_jax():
    (_, japply, _), (_, apply, _) = _models()
    jtree = _jax_tree()
    x, u = _batch()
    got = apply(convert.convert_params(jtree), torch.from_numpy(x),
                torch.from_numpy(u.astype(np.int64)))
    want = japply(jtree, jnp.asarray(x), jnp.asarray(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _grads(loss_fn, params, x, u, gen=None, train=False):
    live = [p.detach().requires_grad_() for p in
            tree_util.leaves(params)]
    tree = tree_util.fill_like(params, live)
    loss = loss_fn(tree, torch.from_numpy(x),
                   torch.from_numpy(u.astype(np.int64)), gen=gen,
                   train=train)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), tree_util.fill_like(params, grads)


def test_loss_and_gradients_match_jax():
    (_, _, jloss), (_, _, loss_fn) = _models()
    jtree = _jax_tree(1)
    x, u = _batch(1)
    jl, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(x), jnp.asarray(u), train=False)))(
        jtree)
    loss, grads = _grads(loss_fn, convert.convert_params(jtree), x, u)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)


def test_the_decoder_is_not_regularized():
    """``reg`` covers enc.w, enc.b and user_emb, not dec (cdae.py:46-49):
    raising l2 moves the decoder's gradients by nothing."""
    x, u = _batch(2)
    params = convert.convert_params(_jax_tree(2))
    grads = {}
    for l2 in (0.0, 1.0):
        _, _, loss_fn = C.make_cdae(ITEMS, USERS + 1, HIDDEN, DROP, l2)
        grads[l2] = convert.export_params(_grads(loss_fn, params, x, u)[1])
    for k in ("w", "b"):
        np.testing.assert_array_equal(grads[0.0]["dec"][k],
                                      grads[1.0]["dec"][k])
        assert not np.allclose(grads[0.0]["enc"][k], grads[1.0]["enc"][k])
    assert not np.allclose(grads[0.0]["user_emb"], grads[1.0]["user_emb"])


def test_train_mode_with_the_ports_mask_matches_jax():
    (_, _, jloss), (_, _, loss_fn) = _models()
    jtree = _jax_tree(3)
    x, u = _batch(3)
    loss, grads = _grads(loss_fn, convert.convert_params(jtree), x, u,
                         gen=torch.Generator().manual_seed(4), train=True)
    mask = (torch.rand(x.shape, generator=torch.Generator().manual_seed(4))
            < 1.0 - DROP).numpy()

    def jf(p):
        h = jnp.where(mask, x / (1.0 - DROP), 0.0)
        h = jax.nn.relu(jnn.dense(p["enc"], h) + p["user_emb"][u])
        y = jax.nn.sigmoid(jnn.dense(p["dec"], h))
        reg = L2 * (jnp.sum(p["enc"]["w"] ** 2) + jnp.sum(p["enc"]["b"] ** 2)
                    + jnp.sum(p["user_emb"] ** 2))
        return jnp.mean((y - x) ** 2) + reg

    jl, jgrads = jax.jit(jax.value_and_grad(jf))(jtree)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    clean = float(jloss(jtree, jnp.asarray(x), jnp.asarray(u), train=False))
    assert abs(clean - float(jl)) > 1e-4


def test_one_adam_step_matches_jax():
    (_, _, jloss), (_, _, loss_fn) = _models()
    jtree = _jax_tree(5)
    x, u = _batch(5)
    jopt, opt = joptim.adam(1e-3), optim.adam(1e-3)
    g = jax.jit(jax.grad(lambda p: jloss(p, jnp.asarray(x), jnp.asarray(u),
                                         train=False)))(jtree)
    jtree2, _ = jopt.update(g, jopt.init(jtree), jtree)
    params = convert.convert_params(jtree)
    _, grads = _grads(loss_fn, params, x, u)
    opt.update(grads, opt.init(params), params)
    _assert_trees_close(params, jtree2, atol=2e-5, rtol=0)


def test_predict_topn_matches_jax():
    (_, japply, _), (_, apply, _) = _models()
    jtree = _jax_tree(6)
    users, train_x, _, _ = ML.synthetic_ml100k(USERS, ITEMS, seed=6)
    got = C.predict_topn(apply, convert.convert_params(jtree), train_x,
                         users, 10)
    want = JC.predict_topn(japply, jtree, train_x, users, 10)
    assert got.shape == want.shape == (USERS, 10)
    np.testing.assert_array_equal(got, want)
    watched = np.take_along_axis(train_x, got, axis=1)
    assert not watched.any()


def test_train_cdae_learns():
    users, train_x, _, test_x = ML.synthetic_ml100k(n_users=150, n_items=80,
                                                    seed=5)
    params, apply, losses = C.train_cdae(
        train_x, users, hidden=16, epochs=15, batch_size=32, device="cpu")
    assert len(losses) == 15 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    pred = C.predict_topn(apply, params, train_x, users, n=10)
    assert pred.shape == (150, 10)
    assert M.success_rate_at_n(pred, test_x) > 15.0   # random: 10/80 ≈ 12%


def test_train_cdae_draws_from_its_seed_alone():
    users, train_x, _, _ = ML.synthetic_ml100k(n_users=64, n_items=40,
                                               seed=1)
    runs = [C.train_cdae(train_x, users, hidden=8, epochs=3, batch_size=16,
                         seed=s, device="cpu")[2] for s in (3, 3, 4)]
    assert runs[0] == runs[1] != runs[2]
    with pytest.raises(ValueError, match="no batch"):
        C.train_cdae(train_x, users, batch_size=65, device="cpu")
