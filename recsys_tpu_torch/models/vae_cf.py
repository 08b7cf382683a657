"""Multi-DAE / Multi-VAE^PR / Logistic-VAE collaborative filtering
(counterpart of ``recsys_tpu/models/vae_cf.py``; the reference's
vae-cf/vae_cf_model.py).

- MultiDAE (vae_cf_model.py:15-99): L2-normalized dropout-corrupted input →
  tanh MLP autoencoder → multinomial log-likelihood.
- MultiVAE (vae_cf_model.py:102-232): the encoder's last layer is 2·latent
  wide (mu‖logvar), z = mu + ε·σ in train mode and mu otherwise, loss =
  neg_ll + β·KL + λ·Σ‖W‖² (kernels only), KL averaged over the batch; β is
  the trainer's (`anneal_schedule`).
- Logistic-VAE: the same with a per-entry sigmoid cross-entropy likelihood
  (`sigmoid_ce`: the JAX package's values, TF's gradient at a logit of 0).

Plain functions on tensors over the JAX model's parameter tree
(``{"layers": [{"w", "b"}, ...]}`` for the DAE, ``{"q": [...], "p": [...]}``
for the VAE; kernels ``[in, out]``), so a converted JAX tree drops in.
Glorot-uniform kernels and truncated-normal(0.001) biases come from
`ops.nn`'s initializers, drawn from an explicit CPU generator. Dropout is
inverted dropout at rate ``1 − keep_prob`` (`nn.dropout`); in train mode
the VAE draws its dropout mask and then ε from one generator ``gen``.
Every op is a dense matmul, a tanh, a ``log_softmax`` or an elementwise
pass: the JAX package leaves them all to XLA, and no kernel of the port's
own lies on this path.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import nn


def _layer_init(gen: torch.Generator, d_in: int, d_out: int, device):
    return {
        "w": nn.glorot_uniform(gen, (d_in, d_out), device),
        "b": nn.truncated_normal(gen, (d_out,), 0.001, device),
    }


def _mlp_chain(layers, h, final_linear=True):
    for i, lp in enumerate(layers):
        h = h @ lp["w"] + lp["b"]
        if i != len(layers) - 1 or not final_linear:
            h = torch.tanh(h)
    return h


def l2_normalize(x, dim=1, eps=1e-12):
    """``x / sqrt(max(Σx², eps))``: the squared norm is clamped, as in the
    reference (``F.normalize`` clamps the norm instead)."""
    return x / torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True),
                                      min=eps))


def _multinomial_neg_ll(logits, x):
    return -torch.mean(torch.sum(torch.log_softmax(logits, dim=1) * x, dim=1))


def sigmoid_ce(logits, x):
    """``relu(l) − l·x + log1p(exp(−|l|))`` per entry, written as
    ``tf.nn.sigmoid_cross_entropy_with_logits`` writes it: both branches
    chosen by ``l >= 0``. The values are bitwise those of the JAX
    package's expression computed in torch; the gradient is σ(l) − x
    everywhere, at l = 0.0 too, where ``relu`` and ``abs`` (and the JAX
    package's ``maximum`` and ``abs``) give −x. A float32 logit lands on
    exactly 0.0 about once in 10⁸, at places that depend on the summation
    order, so that jump would make the card and the CPU disagree."""
    pos = logits >= 0
    return (torch.where(pos, logits, 0.0) - logits * x
            + torch.log1p(torch.exp(torch.where(pos, -logits, logits))))


def make_multi_dae(p_dims: tuple[int, ...], lam: float = 0.01):
    """p_dims e.g. (200, 600, n_items); q_dims is the reverse
    (vae_cf_model.py:17-24). Returns (init, apply, loss_fn)."""
    q_dims = tuple(reversed(p_dims))
    dims = q_dims + p_dims[1:]

    def init(gen: torch.Generator, device):
        return {"layers": [_layer_init(gen, d_in, d_out, device)
                           for d_in, d_out in zip(dims[:-1], dims[1:])]}

    def apply(params, x, *, train=False, gen=None, keep_prob=0.5):
        h = l2_normalize(x, dim=1)
        if train and gen is not None:
            h = nn.dropout(h, 1.0 - keep_prob, True, gen)
        return _mlp_chain(params["layers"], h)

    def loss_fn(params, x, *, gen=None, train=True, keep_prob=0.5):
        logits = apply(params, x, train=train, gen=gen, keep_prob=keep_prob)
        neg_ll = _multinomial_neg_ll(logits, x)
        reg = sum(torch.sum(lp["w"] ** 2) for lp in params["layers"])
        # reference: 2 * l2_regularizer(lam) == lam * Σ‖W‖²
        return neg_ll + lam * reg, {"neg_ll": neg_ll}

    return init, apply, loss_fn


def make_multi_vae(p_dims: tuple[int, ...], lam: float = 0.0,
                   likelihood: str = "multinomial"):
    """MultiVAE^PR (lam=0.0 as the reference's best run) or Logistic-VAE
    (likelihood='logistic'). Returns (init, apply, loss_fn); ``apply``
    gives (logits, kl)."""
    if likelihood not in ("multinomial", "logistic"):
        raise ValueError(likelihood)
    q_dims = tuple(reversed(p_dims))
    latent = p_dims[0]

    def init(gen: torch.Generator, device):
        q_layers = []
        for i, (d_in, d_out) in enumerate(zip(q_dims[:-1], q_dims[1:])):
            if i == len(q_dims) - 2:
                d_out *= 2      # mu ‖ logvar (vae_cf_model.py:195-198)
            q_layers.append(_layer_init(gen, d_in, d_out, device))
        p_layers = [_layer_init(gen, d_in, d_out, device)
                    for d_in, d_out in zip(p_dims[:-1], p_dims[1:])]
        return {"q": q_layers, "p": p_layers}

    def encode(params, x, *, train=False, gen=None, keep_prob=0.5):
        h = l2_normalize(x, dim=1)
        if train and gen is not None:
            h = nn.dropout(h, 1.0 - keep_prob, True, gen)
        h = _mlp_chain(params["q"], h)
        mu, logvar = h[:, :latent], h[:, latent:]
        kl = torch.mean(torch.sum(
            0.5 * (-logvar + torch.exp(logvar) + mu ** 2 - 1.0), dim=1))
        return mu, logvar, kl

    def apply(params, x, *, train=False, gen=None, keep_prob=0.5):
        mu, logvar, kl = encode(params, x, train=train, gen=gen,
                                keep_prob=keep_prob)
        if train and gen is not None:
            eps = torch.randn(mu.shape, generator=gen, device=gen.device)
            z = mu + eps.to(mu.device) * torch.exp(0.5 * logvar)
        else:
            z = mu   # is_training_ph defaults to 0 at scoring
        return _mlp_chain(params["p"], z), kl

    def loss_fn(params, x, anneal, *, gen=None, train=True, keep_prob=0.5):
        logits, kl = apply(params, x, train=train, gen=gen,
                           keep_prob=keep_prob)
        if likelihood == "multinomial":
            neg_ll = _multinomial_neg_ll(logits, x)
        else:
            neg_ll = torch.mean(torch.sum(sigmoid_ce(logits, x), dim=1))
        reg = sum(torch.sum(lp["w"] ** 2)
                  for lp in params["q"] + params["p"])
        neg_elbo = neg_ll + anneal * kl + lam * reg
        return neg_elbo, {"neg_ll": neg_ll, "kl": kl}

    return init, apply, loss_fn


def anneal_schedule(step: int, cap: float = 0.2,
                    total_anneal_steps: int = 200_000) -> float:
    """β = min(cap, step/total) (vae_cf_train_val.py:79-81,184-187)."""
    if total_anneal_steps > 0:
        return min(cap, 1.0 * step / total_anneal_steps)
    return cap
