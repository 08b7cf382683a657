"""The CF family in the port (Multi-DAE, Multi-VAE, Logistic-VAE, their
trainer, CLI and ranking metrics, the MovieLens data) against the JAX
package, at a small size (300 items, p_dims (16, 48, I), batch 32), on the
same numpy inputs made from a seed.

- ``data.movielens``: identical arrays for a seed (exact: the same numpy
  and scipy code), ``load_ml20m`` on a small ``ratings.csv`` (numpy in the
  port, pandas in the JAX package) and ``load_ml100k`` identical;
- ``ndcg_at_k`` / ``recall_at_k`` on seeded scores with disjoint fold-in
  and held-out items (1e-6: float32 sums of at most k terms);
- each model's forward, loss and every gradient from one converted JAX
  tree at ``train=False`` (1e-5 on values, 2e-6 absolute + 1e-4 relative
  on gradients: float32 sums of the same terms in another order); the
  train path with the port's own dropout mask and ε fed to the JAX
  model's pieces (the same tolerances);
- 3 Adam steps (2e-5: Adam's first steps move a weight by about lr·sign(g),
  so a gradient that differs by rounding moves it by a few ulps of 1e-3);
- the whole trainer for ``multi_dae`` at ``keep_prob=1.0`` (no randomness
  in either package) from JAX's initial parameters: per-epoch losses and
  validation NDCG@100 within 1e-4 relative (4 epochs of Adam on float32
  sums in another order), the same best epoch and step, the test metrics
  within 1e-4; checkpoints of either trainer restore in the other; the
  CLI on the CPU, and its refusal of ``--device=cuda`` without a card.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.core.checkpoint import CheckpointManager as JCkpt
from recsys_tpu.data import movielens as JML
from recsys_tpu.models import vae_cf as JV
from recsys_tpu.train import metrics as JM
from recsys_tpu.train import optim as joptim
from recsys_tpu.train import summaries as jsummaries
from recsys_tpu.train import vae_loop as jloop
from recsys_tpu.tools import train_vae as jcli
from recsys_tpu_torch import convert
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.data import movielens as ML
from recsys_tpu_torch.models import vae_cf as V
from recsys_tpu_torch.tools import train_vae as cli
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim, summaries
from recsys_tpu_torch.train import vae_loop as loop
from test_torch_train import GRAD_TOL, _assert_trees_close

ITEMS, B = 300, 32
P_DIMS = (16, 48, ITEMS)
MODELS = ["multi_dae", "multi_vae", "logistic_vae"]
ANNEAL = 0.15


def _makers(model, lam=0.05):
    """(JAX (init, apply, loss_fn), port's, vae?) of ``model``."""
    cfg = loop.VaeTrainConfig(model=model, latent_dim=P_DIMS[0],
                              hidden_dim=P_DIMS[1], lam=lam)
    (j, vae) = jloop._make_model(cfg, ITEMS)
    (t, _) = loop.make_model(cfg, ITEMS)
    return j, t, vae


def _jax_tree(model, seed=0):
    (jinit, _, _), _, _ = _makers(model)
    return jax.tree.map(np.asarray, jinit(jax.random.key(seed)))


def _batch(n=B, seed=0, density=0.1):
    """A binary [n, ITEMS] batch; row 0 empty, row 1 a single item."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, ITEMS)) < density).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, 7] = 1.0
    return x


def _vae_data(n_items=ITEMS, seed=3):
    u, i, r = JML.synthetic_interactions(n_users=400, n_items=n_items,
                                         seed=seed)
    return JML.preprocess_vae_cf(u, i, r, n_heldout_users=60,
                                 rating_threshold=0.0)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _assert_csr_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _assert_vae_data_equal(t, j):
    assert t.n_items == j.n_items
    for f in ("train", "vad_tr", "vad_te", "test_tr", "test_te"):
        _assert_csr_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("seed,threshold", [(3, 0.0), (7, 3.5)])
def test_movielens_arrays_identical_to_jax(seed, threshold):
    kw = dict(n_users=300, n_items=120, seed=seed)
    for a, b in zip(ML.synthetic_interactions(**kw),
                    JML.synthetic_interactions(**kw)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    u, i, r = JML.synthetic_interactions(**kw)
    pkw = dict(n_heldout_users=40, rating_threshold=threshold, seed=seed)
    _assert_vae_data_equal(ML.preprocess_vae_cf(u, i, r, **pkw),
                           JML.preprocess_vae_cf(u, i, r, **pkw))
    for a, b in zip(ML.synthetic_ml100k(100, 60, seed=seed),
                    JML.synthetic_ml100k(100, 60, seed=seed)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_heldout_items_are_disjoint_from_the_fold_in():
    data = ML.preprocess_vae_cf(*ML.synthetic_interactions(
        n_users=400, n_items=150, seed=3), n_heldout_users=60,
        rating_threshold=0.0)
    assert data.vad_tr.multiply(data.vad_te).nnz == 0
    assert data.test_tr.multiply(data.test_te).nnz == 0


def test_load_ml20m_reads_ratings_csv_as_the_jax_package_does(tmp_path):
    rng = np.random.default_rng(11)
    n = 6000
    users = rng.integers(1, 400, n)
    movies = rng.integers(1, 250, n) * 7          # sparse, large movie ids
    ratings = rng.integers(1, 11, n) / 2.0        # 0.5 … 5.0, as ML-20M
    path = tmp_path / "ratings.csv"
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for u, m, r in zip(users, movies, ratings):
            f.write(f"{u},{m},{r:.1f},{1100000000 + int(u)}\n")
    kw = dict(n_heldout_users=50)
    _assert_vae_data_equal(ML.load_ml20m(str(path), **kw),
                           JML.load_ml20m(str(path), **kw))


def test_load_ml100k_identical_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name in ("ua.base", "ua.test"):
        with open(tmp_path / name, "w") as f:
            for _ in range(500):
                f.write(f"{rng.integers(1, 31)}\t{rng.integers(1, 41)}\t"
                        f"{rng.integers(1, 6)}\t881250949\n")
    args = (str(tmp_path / "ua.base"), str(tmp_path / "ua.test"), 30, 40)
    for a, b in zip(ML.load_ml100k(*args), JML.load_ml100k(*args)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ranking metrics
# ---------------------------------------------------------------------------

def _ranking_inputs(n=48, seed=0):
    """Seeded scores with each user's fold-in items masked to -inf and
    held-out items disjoint from them; users with 0 held-out items, with
    one, and with more than 100 among them."""
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((n, ITEMS)).astype(np.float32)
    fold_in = rng.random((n, ITEMS)) < 0.1
    heldout = ((rng.random((n, ITEMS)) < 0.08) & ~fold_in)
    heldout[0] = False
    heldout[1] = False
    heldout[1, np.flatnonzero(~fold_in[1])[0]] = True
    heldout[2] = ~fold_in[2]                      # > 100 held-out items
    scores[fold_in] = -np.inf
    return scores, heldout.astype(np.float32)


@pytest.mark.parametrize("k", [1, 20, 50, 100])
def test_ndcg_and_recall_match_jax(k):
    scores, heldout = _ranking_inputs(seed=k)
    t_s, t_h = torch.from_numpy(scores), torch.from_numpy(heldout)
    j_s, j_h = jnp.asarray(scores), jnp.asarray(heldout)
    ndcg = M.ndcg_at_k(t_s, t_h, k=k).numpy()
    np.testing.assert_allclose(ndcg, np.asarray(JM.ndcg_at_k(j_s, j_h, k=k)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        M.recall_at_k(t_s, t_h, k=k).numpy(),
        np.asarray(JM.recall_at_k(j_s, j_h, k=k)), atol=1e-6, rtol=0)
    assert ndcg[0] == 0.0 and 0.0 <= ndcg.min() and ndcg.max() <= 1.0 + 1e-6


def test_numpy_ranking_metrics_identical_to_jax():
    rng = np.random.default_rng(4)
    pred = np.argsort(rng.random((50, 40)), axis=1)[:, -5:]
    true = (rng.random((50, 40)) < 0.05).astype(np.float32)
    assert M.success_rate_at_n(pred, true) == JM.success_rate_at_n(pred, true)
    y = (rng.random(200) < 0.3).astype(np.float32)
    p = rng.random(200)
    assert M.normalized_cross_entropy(y, p) == \
        JM.normalized_cross_entropy(y, p)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_l2_normalize_clamps_the_squared_norm_as_jax_does():
    x = np.zeros((4, 8), np.float32)
    x[1, 2] = 1e-7                                 # norm² 1e-14 < 1e-12
    x[2] = np.arange(8)
    x[3, :3] = [3.0, -4.0, 0.5]
    np.testing.assert_allclose(V.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(JV.l2_normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
    assert float(V.l2_normalize(torch.from_numpy(x))[1, 2]) == \
        pytest.approx(1e-7 / 1e-6)


@pytest.mark.parametrize("step", [0, 1, 999, 40_000, 10**6])
def test_anneal_schedule_matches_jax(step):
    for total in (0, 200_000, 1000):
        assert V.anneal_schedule(step, 0.2, total) == \
            JV.anneal_schedule(step, 0.2, total)


@pytest.mark.parametrize("model", MODELS)
def test_init_has_the_jax_trees_structure_and_distributions(model):
    _, (init, _, _), _ = _makers(model)
    got = convert.export_params(init(torch.Generator().manual_seed(0), "cpu"))
    want = _jax_tree(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.ndim == 1:                 # truncated normal(0.001): |b| ≤ 2σ
            assert np.abs(g).max() <= 0.002 and np.abs(g).max() > 0
        else:                           # glorot uniform
            lim = (6.0 / sum(g.shape)) ** 0.5
            assert np.abs(g).max() <= lim and np.abs(g).max() > 0.9 * lim
    if model != "multi_dae":            # the encoder's last layer: mu‖logvar
        assert got["q"][-1]["w"].shape == (P_DIMS[1], 2 * P_DIMS[0])


def _loss_args(vae, anneal=ANNEAL):
    return (anneal,) if vae else ()


@pytest.mark.parametrize("model", MODELS)
def test_forward_loss_and_gradients_match_jax(model):
    (_, japply, jloss), (_, apply, loss_fn), vae = _makers(model)
    jtree = _jax_tree(model)
    params = convert.convert_params(jtree)
    x = _batch()
    jx = jnp.asarray(x)

    out = apply(params, torch.from_numpy(x))
    jout = japply(jtree, jx)
    if vae:
        np.testing.assert_allclose(float(out[1]), float(jout[1]), rtol=1e-5)
        out, jout = out[0], jout[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)

    def jf(p):
        return jloss(p, jx, *_loss_args(vae), train=False)

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(jtree)
    loss, aux, grads = loop.loss_and_grads(
        loss_fn, vae, params, torch.from_numpy(x), None, ANNEAL, 0.5,
        train=False)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    assert all(np.abs(g).max() > 0 for g in
               jax.tree.leaves(convert.export_params(grads)))


def test_logistic_likelihood_differs_from_the_multinomial():
    (_, _, jmult), (_, _, mult), _ = _makers("multi_vae")
    (_, _, jlogi), (_, _, logi), _ = _makers("logistic_vae")
    params = convert.convert_params(_jax_tree("multi_vae"))
    x = torch.from_numpy(_batch())
    a = float(mult(params, x, ANNEAL, train=False)[0])
    b = float(logi(params, x, ANNEAL, train=False)[0])
    assert abs(a - b) > 1.0
    with pytest.raises(ValueError):
        V.make_multi_vae(P_DIMS, likelihood="poisson")


def test_sigmoid_ce_keeps_the_values_and_is_smooth_at_zero():
    """The logistic likelihood's entries are bitwise those of the JAX
    package's expression in torch (and within rounding of XLA's ``exp`` and
    ``log1p``, 1e-6 relative); their gradient is σ(l) − x, also at
    l = 0.0 exactly, where the JAX package's ``maximum``/``abs`` form gives
    −x (TF's ``sigmoid_cross_entropy_with_logits`` gives σ(0) − x)."""
    rng = np.random.default_rng(3)
    logits = np.concatenate([rng.standard_normal(997) * 5,
                             [0.0, 30.0, -30.0]]).astype(np.float32)
    x = (rng.random(1000) < 0.5).astype(np.float32)
    want = (jnp.maximum(logits, 0) - logits * x
            + jnp.log1p(jnp.exp(-jnp.abs(logits))))
    t = torch.from_numpy(logits).requires_grad_()
    tx = torch.from_numpy(x)
    got = V.sigmoid_ce(t, tx)
    with torch.no_grad():
        same = torch.relu(t) - t * tx + torch.log1p(torch.exp(-t.abs()))
    assert torch.equal(got.detach(), same)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    (g,) = torch.autograd.grad(got.sum(), t)
    sig = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    np.testing.assert_allclose(g.numpy(), sig - x, atol=1e-6, rtol=0)
    jg = jax.grad(lambda l: jnp.sum(jnp.maximum(l, 0) - l * x + jnp.log1p(
        jnp.exp(-jnp.abs(l)))))(jnp.asarray(logits))
    assert float(jg[997]) == -x[997]            # the JAX package's jump
    assert float(g[997]) == 0.5 - x[997]


@pytest.mark.parametrize("model", MODELS)
def test_train_path_with_the_ports_mask_and_eps_matches_jax(model):
    """Train mode: the port draws its dropout mask (keep 0.5) and, for the
    VAEs, ε from one generator; the same mask and ε, drawn again from a
    generator of the same seed, go through the JAX model's pieces."""
    (_, _, jloss), (_, _, loss_fn), vae = _makers(model)
    jtree = _jax_tree(model, seed=2)
    params = convert.convert_params(jtree)
    x = _batch(seed=5)
    keep = 0.5

    loss, aux, grads = loop.loss_and_grads(
        loss_fn, vae, params, torch.from_numpy(x),
        torch.Generator().manual_seed(9), ANNEAL, keep)

    redraw = torch.Generator().manual_seed(9)
    mask = (torch.rand(x.shape, generator=redraw) < keep).numpy()
    eps = torch.randn((B, P_DIMS[0]), generator=redraw).numpy()
    lam = 0.05

    def jf(p):
        h = JV.l2_normalize(jnp.asarray(x))
        h = jnp.where(mask, h / keep, 0.0)
        if not vae:
            logits = JV._mlp_chain(p["layers"], h)
            ll = jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * x, axis=1))
            reg = sum(jnp.sum(lp["w"] ** 2) for lp in p["layers"])
            return -ll + lam * reg, -ll
        h = JV._mlp_chain(p["q"], h)
        mu, logvar = h[:, :P_DIMS[0]], h[:, P_DIMS[0]:]
        kl = jnp.mean(jnp.sum(
            0.5 * (-logvar + jnp.exp(logvar) + mu ** 2 - 1.0), axis=1))
        z = mu + eps * jnp.exp(0.5 * logvar)
        logits = JV._mlp_chain(p["p"], z)
        if model == "multi_vae":
            neg_ll = -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * x, 1))
        else:
            neg_ll = jnp.mean(jnp.sum(
                jnp.maximum(logits, 0) - logits * x
                + jnp.log1p(jnp.exp(-jnp.abs(logits))), axis=1))
        reg = sum(jnp.sum(lp["w"] ** 2) for lp in p["q"] + p["p"])
        return neg_ll + ANNEAL * kl + lam * reg, neg_ll

    (jl, jneg_ll), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jtree)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["neg_ll"]), float(jneg_ll),
                               rtol=1e-5)
    _assert_trees_close(grads, jgrads, **GRAD_TOL)
    # the loss the loop's JAX loss_fn would give without the noise differs
    (jclean, _) = jloss(jtree, jnp.asarray(x), *_loss_args(vae), train=False)
    assert abs(float(jclean) - float(jl)) > 1e-3


@pytest.mark.parametrize("model", MODELS)
def test_three_adam_steps_match_jax(model):
    (_, _, jloss), (_, _, loss_fn), vae = _makers(model)
    jtree = _jax_tree(model, seed=4)
    params = convert.convert_params(jtree)
    jopt, opt = joptim.adam(1e-3), optim.adam(1e-3)
    jstate, state = jopt.init(jtree), opt.init(params)

    @jax.jit
    def jstep(p, s, x):
        g = jax.grad(lambda q: jloss(q, x, *_loss_args(vae),
                                     train=False)[0])(p)
        return jopt.update(g, s, p)

    for s in range(3):
        x = _batch(seed=10 + s)
        jtree, jstate = jstep(jtree, jstate, jnp.asarray(x))
        _, _, grads = loop.loss_and_grads(loss_fn, vae, params,
                                          torch.from_numpy(x), None, ANNEAL,
                                          0.5, train=False)
        opt.update(grads, state, params)
    _assert_trees_close(params, jtree, atol=2e-5, rtol=0)


def test_the_train_step_at_keep_prob_one_is_the_deterministic_step():
    """`make_train_step` (train mode) at keep_prob 1.0 draws nothing for
    the DAE: two runs from one tree agree bitwise, and agree with JAX's
    train-mode step within the Adam tolerance."""
    (_, _, jloss), (_, _, loss_fn), _ = _makers("multi_dae")
    jtree = _jax_tree("multi_dae", seed=6)
    x = _batch(seed=8)
    runs = []
    for _ in range(2):
        params = convert.convert_params(jtree)
        opt = optim.adam(1e-3)
        state = opt.init(params)
        step = loop.make_train_step(loss_fn, False, opt, 1.0)
        gen = torch.Generator().manual_seed(0)
        before = gen.get_state()
        losses = [float(step(params, state, torch.from_numpy(x), gen, 0.0))
                  for _ in range(3)]
        assert torch.equal(gen.get_state(), before)
        runs.append((losses, convert.export_params(params)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(jax.tree.leaves(runs[0][1]), jax.tree.leaves(runs[1][1])):
        np.testing.assert_array_equal(a, b)
    jopt = joptim.adam(1e-3)
    js = jopt.init(jtree)

    @jax.jit
    def jstep(p, s):
        g = jax.grad(lambda q: jloss(q, jnp.asarray(x), rng=jax.random.key(0),
                                     train=True, keep_prob=1.0)[0])(p)
        return jopt.update(g, s, p)

    for _ in range(3):
        jtree, js = jstep(jtree, js)
    for a, b in zip(jax.tree.leaves(runs[0][1]), jax.tree.leaves(jtree)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=0)


@pytest.mark.parametrize("model", ["multi_dae", "multi_vae"])
def test_eval_fn_matches_jax(model):
    (_, japply, _), (_, apply, _), vae = _makers(model)
    jtree = _jax_tree(model, seed=1)
    data = _vae_data()
    assert data.n_items == ITEMS
    want = jloop.make_eval_fn(japply, vae, 16)(jtree, data.vad_tr,
                                                data.vad_te)
    got = loop.make_eval_fn(apply, vae, 16, "cpu")(
        convert.convert_params(jtree), data.vad_tr, data.vad_te)
    assert got["eval_users"] == want["eval_users"] > 0
    for k in ("ndcg@100", "recall@20", "recall@50"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the trainer, its checkpoints and the CLI
# ---------------------------------------------------------------------------

TRAIN_CFG = dict(model="multi_dae", keep_prob=1.0, latent_dim=16,
                 hidden_dim=48, epochs=4, batch_size=64, lam=0.01,
                 eval_batch_size=24, seed=5)


@pytest.fixture(scope="module")
def both_trainers(tmp_path_factory):
    """One multi_dae run of each trainer on one data set, the port's from
    JAX's initial parameters (its model ``init`` patched)."""
    root = tmp_path_factory.mktemp("vae")
    data = _vae_data()
    jcfg = jloop.VaeTrainConfig(model_dir=str(root / "jax"), **TRAIN_CFG)
    tcfg = loop.VaeTrainConfig(model_dir=str(root / "port"), **TRAIN_CFG)
    jresult = jloop.train_vae_cf(data, jcfg)
    jinit = jax.tree.map(np.asarray, JV.make_multi_dae(
        (16, 48, data.n_items), lam=0.01)[0](jax.random.key(jcfg.seed)))
    real = V.make_multi_dae

    def patched(p_dims, lam=0.01):
        _, apply, loss_fn = real(p_dims, lam)
        return (lambda gen, device: convert.convert_params(jinit, device),
                apply, loss_fn)

    mp = pytest.MonkeyPatch()
    mp.setattr(V, "make_multi_dae", patched)
    try:
        result = loop.train_vae_cf(data, tcfg, device="cpu")
    finally:
        mp.undo()
    return data, jcfg, jresult, tcfg, result, jinit


def test_whole_trainer_matches_jax(both_trainers):
    data, jcfg, jresult, tcfg, result, _ = both_trainers
    assert result["best_epoch"] == jresult["best_epoch"]
    assert result["best_step"] == jresult["best_step"]
    np.testing.assert_allclose(result["best_ndcg"], jresult["best_ndcg"],
                               rtol=1e-4)
    assert result["test"]["eval_users"] == jresult["test"]["eval_users"] > 0
    for k in ("ndcg@100", "recall@20", "recall@50"):
        np.testing.assert_allclose(result["test"][k], jresult["test"][k],
                                   rtol=1e-4, atol=1e-6)
    got = summaries.read_scalars(tcfg.model_dir)
    want = jsummaries.read_scalars(jcfg.model_dir)
    assert len(got) == len(want) == TRAIN_CFG["epochs"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["step"], g["epoch"]) == (w["step"], w["epoch"])
        for k in ("loss", "ndcg@100", "recall@20", "recall@50"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
        assert g["anneal"] == w["anneal"]
    # it learned: the last epoch's loss is below the first's
    assert got[-1]["loss"] < got[0]["loss"]


def test_trainer_keeps_the_jax_trainers_checkpoints(both_trainers):
    _, jcfg, jresult, tcfg, result, _ = both_trainers
    for cfg, res in ((jcfg, jresult), (tcfg, result)):
        names = sorted(os.listdir(cfg.model_dir))
        assert "best" in names and "scalars.jsonl" in names
        assert len([n for n in names if n.startswith("step_")]) == 3
        with open(os.path.join(cfg.model_dir, "best", "meta.json")) as f:
            meta = json.load(f)
        assert meta["metric"] == res["best_ndcg"]
        assert meta["extra"]["epoch"] == res["best_epoch"]
        assert meta["step"] == res["best_step"]


def test_checkpoints_of_either_trainer_restore_in_the_other(both_trainers):
    data, jcfg, _, tcfg, _, jinit = both_trainers
    x = _batch()
    _, japply, _ = JV.make_multi_dae((16, 48, data.n_items))
    _, apply, _ = V.make_multi_dae((16, 48, data.n_items))
    for cfg in (jcfg, tcfg):
        jtree, jstep, jextra = JCkpt(cfg.model_dir).restore(jinit, best=True)
        ttree, tstep, textra = CheckpointManager(cfg.model_dir).restore(
            best=True)
        assert (jstep, jextra) == (tstep, textra)
        want = np.asarray(japply(jtree, jnp.asarray(x)))
        got = apply(convert.convert_params(ttree), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _cli_args(tmp_path, name):
    return ["--epochs=2", "--batch_size=100", "--latent_dim=12",
            "--hidden_dim=32", f"--model_dir={tmp_path}/{name}",
            "--synthetic_users=250", "--synthetic_items=120",
            "--n_heldout_users=40", "--total_anneal_steps=200",
            "--eval_batch_size=64"]


def test_cli_trains_validates_and_tests_on_the_cpu(tmp_path, capsys):
    result = cli.main(_cli_args(tmp_path, "port") + ["--device=cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed.keys() == {"best_ndcg", "best_epoch", "best_step", "test"}
    assert printed["best_epoch"] == result["best_epoch"] >= 0
    jresult = jcli.main(_cli_args(tmp_path, "jax"))
    assert result.keys() == jresult.keys()
    assert result["test"].keys() == jresult["test"].keys()
    assert result["test"]["eval_users"] == jresult["test"]["eval_users"]
    assert os.path.isdir(tmp_path / "port" / "best")
    assert len(summaries.read_scalars(str(tmp_path / "port"))) == 2


def test_cli_reads_ratings_csv(tmp_path):
    u, i, r = JML.synthetic_interactions(n_users=200, n_items=120, seed=1)
    path = tmp_path / "ratings.csv"
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for a, b, c in zip(u + 1, i + 1, r):
            f.write(f"{a},{b},{c},0\n")
    result = cli.main(["--device=cpu", f"--ratings_csv={path}",
                       "--n_heldout_users=30", "--epochs=1",
                       "--latent_dim=8", "--hidden_dim=16",
                       "--eval_batch_size=32", "--model=multi_dae",
                       f"--model_dir={tmp_path}/csv"])
    assert result["test"]["eval_users"] > 0


def test_cli_without_a_card_refuses_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="cuda"):
        cli.main(_cli_args(tmp_path, "card"))          # --device defaults
    assert not os.path.exists(tmp_path / "card")


def test_trainer_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = dataclasses.replace(loop.VaeTrainConfig(**TRAIN_CFG),
                              model_dir=str(tmp_path / "x"))
    with pytest.raises((RuntimeError, AssertionError)):
        loop.train_vae_cf(_vae_data(), cfg)
