"""CDAE — Collaborative Denoising Auto-Encoder (counterpart of
``recsys_tpu/models/cdae.py``; the reference's cade/CDAE.py:5-48).

- item-vector input [B, I], dropout-corrupted at rate q (CDAE.py:26);
- hidden dense K plus a per-user embedding [U + 1, K] read with a plain
  row gather and added at the hidden layer (CDAE.py:27-35), ReLU on the
  sum;
- sigmoid output dense back to I items (CDAE.py:38);
- MSE reconstruction loss plus ``l2 · (‖enc.w‖² + ‖enc.b‖² + ‖user_emb‖²)``
  (the decoder is not regularized), Adam (cade/train.py:20-27);
- top-N prediction masks already-watched items by multiplying them to 0
  and ranks with ``np.argsort`` on the host, as the reference does
  (train.py:30-33): ties at 0 follow numpy's sort, so that stays numpy.

The parameter tree is the JAX model's (``enc``, ``user_emb``, ``dec``;
kernels ``[in, out]``), so a converted JAX tree drops in. The device is
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.ops import nn
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train.train_state import make_generator


def make_cdae(n_items: int, n_users: int, hidden: int = 50,
              drop_rate: float = 0.5, l2: float = 0.01):
    """(init, apply, loss_fn) of a CDAE with ``n_users`` embedding rows."""

    def init(gen: torch.Generator, device):
        return {
            "enc": nn.dense_init(gen, n_items, hidden, device),
            "user_emb": nn.glorot_uniform(gen, (n_users, hidden), device),
            "dec": nn.dense_init(gen, hidden, n_items, device),
        }

    def apply(params, x_items, user_ids, *, train=False, gen=None):
        h = x_items
        if train and gen is not None:
            h = nn.dropout(h, drop_rate, True, gen)
        h = nn.dense(params["enc"], h)
        h = h + torch.index_select(params["user_emb"], 0, user_ids)
        return torch.sigmoid(nn.dense(params["dec"], torch.relu(h)))

    def loss_fn(params, x_items, user_ids, *, gen=None, train=True):
        y = apply(params, x_items, user_ids, train=train, gen=gen)
        mse = torch.mean((y - x_items) ** 2)
        reg = l2 * (
            torch.sum(params["enc"]["w"] ** 2)
            + torch.sum(params["enc"]["b"] ** 2)
            + torch.sum(params["user_emb"] ** 2)
        )
        return mse + reg

    return init, apply, loss_fn


def train_cdae(
    train_x: np.ndarray, train_users: np.ndarray,
    *, hidden: int = 50, epochs: int = 100, batch_size: int = 128,
    lr: float = 1e-3, seed: int = 0, drop_rate: float = 0.5, l2: float = 0.01,
    device="cuda",
):
    """Fit loop (cade/train.py:24-27 semantics, bounded epochs): each epoch
    a permutation of the users from one generator on ``device``, full
    batches only (the tail is dropped), and one host read of the epoch's
    last loss. Returns (params, apply, losses)."""
    device = torch.device(device)
    n_users, n_items = train_x.shape
    if n_users < batch_size:
        raise ValueError(f"{n_users} users make no batch of {batch_size}")
    init, apply, loss_fn = make_cdae(n_items, n_users + 1, hidden,
                                     drop_rate, l2)
    params = init(torch.Generator().manual_seed(seed), device)
    opt = optim.adam(lr)
    opt_state = opt.init(params)
    gen = make_generator(seed + 1, device)

    def step(xb, ub):
        live = [p.detach().requires_grad_()
                for p in tree_util.leaves(params)]
        loss = loss_fn(tree_util.fill_like(params, live), xb, ub, gen=gen)
        grads = torch.autograd.grad(loss, live)
        opt.update(tree_util.fill_like(params, grads), opt_state, params)
        return loss.detach()

    x = torch.from_numpy(np.asarray(train_x, np.float32)).to(device)
    u = torch.from_numpy(train_users.astype(np.int64)).to(device)
    losses = []
    for _ in range(epochs):
        perm = torch.randperm(n_users, generator=gen, device=device)
        for lo in range(0, n_users - batch_size + 1, batch_size):
            idx = perm[lo:lo + batch_size]
            loss = step(x[idx], u[idx])
        losses.append(float(loss))
    return params, apply, losses


def predict_topn(apply, params, train_x: np.ndarray, users: np.ndarray,
                 n: int) -> np.ndarray:
    """Scores → mask watched → top-N item indices (train.py:30-33)."""
    device = tree_util.leaves(params)[0].device
    with torch.no_grad():
        pred = apply(params,
                     torch.from_numpy(np.asarray(train_x, np.float32)
                                      ).to(device),
                     torch.from_numpy(users.astype(np.int64)).to(device))
    pred = pred.cpu().numpy() * (train_x == 0)
    return np.argsort(pred, axis=1)[:, -n:]
