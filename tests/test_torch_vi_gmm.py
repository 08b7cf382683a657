"""The CAVI demo in the port against the JAX package: ``cavi_step``,
``elbo`` and ``reference_elbo`` from one numpy state (float32: 1e-5
relative on the ELBOs, sums of N·K terms; 1e-5 on phi, m and s2), and
``fit_from`` started from the JAX ``fit``'s own initial state, which must
stop at the sweep where the JAX ``while_loop`` stops, with its means within
1e-4, wherever epsilon is above the float32 ELBO's rounding. The port's
``fit`` alone recovers separated means and its ELBO does not fall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.extras import vi_gmm as JG
from recsys_tpu_torch.extras import vi_gmm as G


def _numpy_state(n=200, k=3, seed=0):
    rng = np.random.default_rng(seed)
    data = np.concatenate([rng.normal(c, 1.0, n // k) for c in
                           np.linspace(-3, 3, k)]).astype(np.float32)
    phi = rng.random((len(data), k)).astype(np.float32)
    m = rng.standard_normal(k).astype(np.float32)
    s2 = (rng.random(k) + 0.1).astype(np.float32)
    return data, phi, m, s2


def _states(data, phi, m, s2):
    jstate = JG.GmmState(jnp.asarray(phi), jnp.asarray(m), jnp.asarray(s2),
                         jnp.asarray(-np.inf, jnp.float32),
                         jnp.zeros((), jnp.int32))
    state = G.GmmState(torch.from_numpy(phi), torch.from_numpy(m),
                       torch.from_numpy(s2),
                       torch.tensor(-np.inf, dtype=torch.float32),
                       torch.zeros((), dtype=torch.int32))
    return jnp.asarray(data), jstate, torch.from_numpy(data), state


def _assert_states_close(got, want, rtol=1e-5):
    for f in ("phi", "m", "s2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(float(got.elbo), float(want.elbo), rtol=rtol)
    assert int(got.it) == int(want.it)


@pytest.mark.parametrize("k,sigma", [(2, 1.0), (3, 2.0), (5, 0.7)])
def test_cavi_step_and_elbos_match_jax(k, sigma):
    jdata, jstate, data, state = _states(*_numpy_state(k=k, seed=k))
    for _ in range(3):
        jstate = JG.cavi_step(jdata, jstate, sigma)
        state = G.cavi_step(data, state, sigma)
        _assert_states_close(state, jstate)
        for fn in ("elbo", "reference_elbo"):
            np.testing.assert_allclose(
                float(getattr(G, fn)(data, state, sigma)),
                float(getattr(JG, fn)(jdata, jstate, sigma)), rtol=1e-5,
                err_msg=fn)


@pytest.mark.parametrize("seed,means,eps", [
    (1, [-4.0, 0.0, 4.0], 1e-2),
    (2, [-2.0, 3.0], 5e-3),
    (3, [-6.0, -1.0, 2.0, 7.0], 1e-2),
])
def test_fit_from_stops_at_the_jax_fits_sweep(seed, means, eps):
    """The same stop needs an epsilon of at least 8 ulps of the float32
    ELBO: below that the last differences are rounding, which two float32
    sums in another order do not share (at |ELBO| ≈ 4,800 one ulp is
    4.9e-4, so epsilon 1e-4 stops either package where its rounding
    lands)."""
    k = len(means)
    jdata = JG.sample_gmm(jax.random.key(seed + 100), means, 1.0, 300)
    key = jax.random.key(seed)
    want = JG.fit(key, jdata, k, sigma=1.0, epsilon=eps, max_iters=500)
    assert eps >= 8 * np.spacing(np.float32(abs(float(want.elbo))))
    init = JG.init_state(key, jdata, k)
    data, state = _states(np.array(jdata), *(np.array(x) for x in
                                             init[:3]))[2:]
    got = G.fit_from(data, state, sigma=1.0, epsilon=eps, max_iters=500)
    assert 3 < int(got.it) < 500
    assert int(got.it) == int(want.it)
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m), atol=1e-4)
    np.testing.assert_allclose(got.s2.numpy(), np.asarray(want.s2),
                               rtol=1e-5)


def test_fit_from_stops_at_max_iters():
    jdata = JG.sample_gmm(jax.random.key(7), [-1.0, 1.0], 1.0, 100)
    key = jax.random.key(8)
    want = JG.fit(key, jdata, 2, epsilon=0.0, max_iters=7)
    init = JG.init_state(key, jdata, 2)
    data, state = _states(np.array(jdata), *(np.array(x) for x in
                                             init[:3]))[2:]
    got = G.fit_from(data, state, epsilon=0.0, max_iters=7)
    assert int(got.it) == int(want.it) == 7


def test_fit_recovers_separated_means():
    gen = torch.Generator().manual_seed(2)
    data = G.sample_gmm(gen, [-4.0, 0.0, 4.0], 1.0, 500, device="cpu")
    assert data.shape == (1500,) and data.dtype == torch.float32
    final = G.fit(torch.Generator().manual_seed(1), data, 3, sigma=1.0,
                  epsilon=1e-4, max_iters=500)
    np.testing.assert_allclose(np.sort(final.m.numpy()), [-4.0, 0.0, 4.0],
                               atol=0.25)
    assert int(final.it) < 500


def test_init_state_draws_inside_the_data_range():
    gen = torch.Generator().manual_seed(3)
    data = G.sample_gmm(gen, [0.0, 3.0], 1.0, 300, device="cpu")
    state = G.init_state(gen, data, 4)
    assert state.phi.shape == (600, 4) and state.it.dtype == torch.int32
    assert float(state.m.min()) >= float(data.min())
    assert float(state.m.max()) <= float(data.max())
    assert bool((state.s2 > 0).all() & (state.s2 < 1).all())
    assert float(state.elbo) == -np.inf


def test_elbo_does_not_fall():
    gen = torch.Generator().manual_seed(4)
    data = G.sample_gmm(gen, [0.0, 3.0], 1.0, 300, device="cpu")
    state = G.cavi_step(data, G.init_state(gen, data, 2), 1.0)
    prev = float(state.elbo)
    for _ in range(10):
        state = G.cavi_step(data, state, 1.0)
        assert float(state.elbo) >= prev - 1e-3
        prev = float(state.elbo)
