"""CAVI for a Gaussian mixture — the variational-inference teaching demo
(counterpart of ``recsys_tpu/extras/vi_gmm.py``; the reference's
vae-cf/vi_gmm.py:11-87): coordinate-ascent variational inference for a
K-component univariate GMM with known, shared observation variance and a
N(0, sigma²) prior on the component means.

Where the JAX package runs the fit as one ``lax.while_loop``, `fit_from`
is a host loop over device tensors that applies the same test after every
sweep (start with ``prev = inf`` and one sweep from the initial state, go
on while ``|elbo − prev| > epsilon`` and ``it < max_iters``, the
difference taken in float32 on the device), so it stops at the sweep
where the JAX loop stops. `fit` is `init_state` plus `fit_from`.

Math (identical to vi_gmm.py:34-43):
    phi_ik ∝ exp(x_i·m_k − (m_k² + s2_k)/2)            (responsibilities)
    m_k    = Σ_i phi_ik·x_i / (1/sigma² + Σ_i phi_ik)  (mean update)
    s2_k   = 1 / (1/sigma² + Σ_i phi_ik)               (variance update)
with the reference's ELBO expression (vi_gmm.py:25-32), its
``−Σ log phi`` entropy-sign quirk included, as `reference_elbo`, and a
standard ELBO (`elbo`) for convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GmmState(NamedTuple):
    phi: torch.Tensor   # [N, K] responsibilities
    m: torch.Tensor     # [K] variational means
    s2: torch.Tensor    # [K] variational variances
    elbo: torch.Tensor  # [] current ELBO
    it: torch.Tensor    # [] iteration counter (int32)


def init_state(gen: torch.Generator, data: torch.Tensor,
               num_clusters: int) -> GmmState:
    """Random init mirroring vi_gmm.py:16-23: uniform phi, means drawn
    inside the data range, uniform s2; drawn from ``gen`` on its device,
    placed on ``data``'s."""
    n = data.shape[0]

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=gen.device)
        return (lo + (hi - lo) * u).to(data.device)

    phi = uniform((n, num_clusters))
    m = uniform((num_clusters,), float(data.min()), float(data.max()))
    s2 = uniform((num_clusters,))
    return GmmState(phi, m, s2,
                    torch.tensor(-torch.inf, dtype=torch.float32,
                                 device=data.device),
                    torch.zeros((), dtype=torch.int32, device=data.device))


def cavi_step(data: torch.Tensor, state: GmmState,
              sigma: float) -> GmmState:
    """One coordinate-ascent sweep (vi_gmm.py:34-43)."""
    e = torch.outer(data, state.m) - 0.5 * (state.m**2 + state.s2)[None, :]
    phi = torch.softmax(e, dim=1)
    denom = 1.0 / sigma**2 + torch.sum(phi, dim=0)
    m = (data @ phi) / denom
    s2 = 1.0 / denom
    new = GmmState(phi, m, s2, state.elbo, state.it + 1)
    return new._replace(elbo=elbo(data, new, sigma))


def elbo(data: torch.Tensor, state: GmmState, sigma: float) -> torch.Tensor:
    """Standard mean-field ELBO (up to additive constants in x)."""
    phi, m, s2 = state.phi, state.m, state.s2
    p_mean = -torch.sum((m**2 + s2) / (2.0 * sigma**2))
    ll = torch.sum(phi * (torch.outer(data, m) - 0.5 * (m**2 + s2)[None, :]))
    ent_c = -torch.sum(phi * torch.log(torch.clamp(phi, min=1e-12)))
    ent_mu = 0.5 * torch.sum(torch.log(s2))
    return p_mean + ll + ent_c + ent_mu


def reference_elbo(data: torch.Tensor, state: GmmState,
                   sigma: float) -> torch.Tensor:
    """The reference's exact ELBO expression, quirks included
    (vi_gmm.py:25-32: ``p3 = −Σ log phi`` rather than −Σ phi·log phi)."""
    phi, m, s2 = state.phi, state.m, state.s2
    p1 = -torch.sum((m**2 + s2) / (2.0 * sigma**2))
    p2 = torch.sum(
        (-0.5 * (data[:, None] ** 2 + (m**2 + s2)[None, :])
         + torch.outer(data, m)) * phi
    )
    p3 = -torch.sum(torch.log(torch.clamp(phi, min=1e-12)))
    p4 = 0.5 * torch.sum(torch.log(s2))
    return p1 + p2 + p3 + p4


def fit_from(data: torch.Tensor, state: GmmState, *, sigma: float = 1.0,
             epsilon: float = 1e-3, max_iters: int = 1000) -> GmmState:
    """CAVI from ``state`` to epsilon-convergence of the ELBO
    (vi_gmm.py:45-59): the JAX ``while_loop``'s test, one host read a
    sweep. Returns the final state (``state.it`` = sweeps run)."""
    state = cavi_step(data, state, sigma)
    prev = torch.tensor(torch.inf, dtype=torch.float32, device=data.device)
    while bool((torch.abs(state.elbo - prev) > epsilon)
               & (state.it < max_iters)):
        prev = state.elbo
        state = cavi_step(data, state, sigma)
    return state


def fit(gen: torch.Generator, data: torch.Tensor, num_clusters: int, *,
        sigma: float = 1.0, epsilon: float = 1e-3,
        max_iters: int = 1000) -> GmmState:
    """`init_state` from ``gen``, then `fit_from`."""
    return fit_from(data, init_state(gen, data, num_clusters), sigma=sigma,
                    epsilon=epsilon, max_iters=max_iters)


def sample_gmm(gen: torch.Generator, means, sigma: float, n_per_cluster: int,
               device="cuda") -> torch.Tensor:
    """The demo's data generator (vi_gmm.py:73-82): ``n_per_cluster``
    samples per cluster, drawn from ``gen``, on ``device``."""
    means = torch.as_tensor(means, dtype=torch.float32)
    eps = torch.randn((means.shape[0], n_per_cluster), generator=gen,
                      device=gen.device).to(means.device)
    return (means[:, None] + sigma * eps).reshape(-1).to(device)
