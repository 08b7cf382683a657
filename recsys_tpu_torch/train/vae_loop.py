"""The VAE-CF trainer (counterpart of ``recsys_tpu/train/vae_loop.py``;
the reference's TF training loop, vae-cf/vae_cf_train_val.py:161-272):

- an epoch loop over the training users in the order of
  ``np.random.default_rng(cfg.seed)`` (numpy, so the JAX trainer's order),
  the tail batch kept, β = min(cap, step/total_anneal_steps) every step;
- each step densifies its batch of CSR rows on the host into a [B, I]
  float32 array (as the reference does, vae_cf_train_val.py:173-181),
  copies it to the device and takes one TF-parity Adam step; the step's
  dropout and ε come from one generator on the device, seeded from
  (seed + 1, step) by `train_state.step_seed`;
- per-epoch validation: score the fold-in rows, mask seen items to -inf,
  NDCG@100 over the held-out items, in eval batches padded to a fixed size
  with a ``valid`` mask;
- checkpoints through `CheckpointManager(keep_max=3)` with
  ``metric=ndcg@100`` and ``extra={"epoch"}`` in the JAX on-disk format;
  after training, ``best/`` is restored and the test users are scored on
  it (NDCG@100 / Recall@20 / Recall@50);
- the JAX trainer's ``scalars.jsonl`` records (and a TensorBoard event
  file beside them).

The device is the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from recsys_tpu_torch import convert
from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.checkpoint import CheckpointManager
from recsys_tpu_torch.data.movielens import VaeCfData
from recsys_tpu_torch.models import vae_cf as V
from recsys_tpu_torch.train import metrics as M
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train.summaries import ScalarWriter
from recsys_tpu_torch.train.train_state import make_generator, step_seed

log = logging.getLogger("recsys_tpu_torch.vae")


@dataclass(frozen=True)
class VaeTrainConfig:
    """VAE-CF run config (constants block, vae_cf_train_val.py:64-82)."""

    model: str = "multi_vae"        # multi_vae | multi_dae | logistic_vae
    latent_dim: int = 200           # p_dims=[200, 600, n_items]
    hidden_dim: int = 600
    batch_size: int = 500           # vae_cf_train_val.py:170-181
    epochs: int = 200
    learning_rate: float = 1e-3
    keep_prob: float = 0.5
    anneal_cap: float = 0.2         # vae_cf_train_val.py:79-81
    total_anneal_steps: int = 200_000
    lam: float = 0.0                # best MultiVAE^PR run used no weight decay
    seed: int = 98765
    model_dir: str = "./vae_model"
    eval_batch_size: int = 500


def make_model(cfg: VaeTrainConfig, n_items: int):
    """((init, apply, loss_fn), vae) of ``cfg.model`` at
    p_dims = (latent, hidden, n_items)."""
    p_dims = (cfg.latent_dim, cfg.hidden_dim, n_items)
    if cfg.model == "multi_dae":
        return V.make_multi_dae(p_dims, lam=cfg.lam), False
    if cfg.model == "multi_vae":
        return V.make_multi_vae(p_dims, lam=cfg.lam), True
    if cfg.model == "logistic_vae":
        return V.make_multi_vae(p_dims, lam=cfg.lam,
                                likelihood="logistic"), True
    raise ValueError(f"unknown VAE-CF model {cfg.model!r}")


def dense_rows(mat, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` of a CSR matrix as a dense float32 host array."""
    return np.asarray(mat[idx].todense(), np.float32)


def loss_and_grads(loss_fn, vae: bool, params, x, gen, anneal,
                   keep_prob: float, train: bool = True):
    """(loss, aux, gradient tree) of ``loss_fn`` on batch ``x``,
    differentiated through detached aliases of ``params``."""
    live = [p.detach().requires_grad_() for p in tree_util.leaves(params)]
    tree = tree_util.fill_like(params, live)
    if vae:
        loss, aux = loss_fn(tree, x, anneal, gen=gen, train=train,
                            keep_prob=keep_prob)
    else:
        loss, aux = loss_fn(tree, x, gen=gen, train=train,
                            keep_prob=keep_prob)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_util.fill_like(params, grads))


def make_train_step(loss_fn, vae: bool, opt: optim.Optimizer,
                    keep_prob: float):
    """``step(params, opt_state, x, gen, anneal) -> loss``: one train-mode
    step that updates ``params`` and ``opt_state`` in place."""

    def step(params, opt_state, x, gen, anneal):
        loss, _, grads = loss_and_grads(loss_fn, vae, params, x, gen, anneal,
                                        keep_prob)
        opt.update(grads, opt_state, params)
        return loss

    return step


def make_eval_fn(apply, vae: bool, batch: int, device):
    """Fixed-shape scorer: fold-in rows → (ndcg@100, r@20, r@50) means.

    Scores each fold-in batch on ``device``, masks the seen items to -inf
    (vae_cf_train_val.py:208-210) and sums each metric over the valid rows
    with a held-out item, so padded tail rows contribute nothing."""

    @torch.no_grad()
    def score(params, x_tr, x_te, valid):
        out = apply(params, x_tr, train=False)
        logits = out[0] if vae else out
        logits = torch.where(x_tr > 0, -torch.inf, logits)
        w = ((torch.sum(x_te, dim=1) > 0) & valid).to(torch.float32)
        return torch.stack([
            torch.sum(M.ndcg_at_k(logits, x_te, k=100) * w),
            torch.sum(M.recall_at_k(logits, x_te, k=20) * w),
            torch.sum(M.recall_at_k(logits, x_te, k=50) * w),
            torch.sum(w)])

    def evaluate(params, tr_mat, te_mat) -> dict[str, float]:
        n_users = tr_mat.shape[0]
        sums = np.zeros(4)
        for lo in range(0, n_users, batch):
            idx = np.arange(lo, min(lo + batch, n_users))
            x_tr = dense_rows(tr_mat, idx)
            x_te = dense_rows(te_mat, idx)
            valid = np.ones(len(idx), bool)
            if len(idx) < batch:                      # pad to a fixed shape
                pad = batch - len(idx)
                x_tr = np.pad(x_tr, ((0, pad), (0, 0)))
                x_te = np.pad(x_te, ((0, pad), (0, 0)))
                valid = np.pad(valid, (0, pad))
            out = score(params, torch.from_numpy(x_tr).to(device),
                        torch.from_numpy(x_te).to(device),
                        torch.from_numpy(valid).to(device))
            sums += out.cpu().numpy().astype(np.float64)
        n = max(sums[3], 1.0)
        return {"ndcg@100": sums[0] / n, "recall@20": sums[1] / n,
                "recall@50": sums[2] / n, "eval_users": int(sums[3])}

    return evaluate


def train_vae_cf(data: VaeCfData, cfg: VaeTrainConfig,
                 device="cuda") -> dict:
    """Full train / validate / test protocol. Returns
    {"best_ndcg", "best_epoch", "best_step", "test": {...}}. ``cuda``
    without a card raises; it never falls back to the CPU."""
    device = torch.device(device)
    (init, apply, loss_fn), vae = make_model(cfg, data.n_items)
    params = init(torch.Generator().manual_seed(cfg.seed), device)
    opt = optim.adam(cfg.learning_rate)
    opt_state = opt.init(params)
    train_step = make_train_step(loss_fn, vae, opt, cfg.keep_prob)
    evaluate = make_eval_fn(apply, vae, cfg.eval_batch_size, device)
    mgr = CheckpointManager(cfg.model_dir, keep_max=3)
    rng_np = np.random.default_rng(cfg.seed)
    gen = make_generator(cfg.seed + 1, device)
    n_train = data.train.shape[0]
    bs = min(cfg.batch_size, n_train)
    step = 0
    best = {"ndcg": -1.0, "epoch": -1}

    with ScalarWriter(cfg.model_dir) as writer:
        for epoch in range(cfg.epochs):
            order = rng_np.permutation(n_train)
            losses = []
            # the whole epoch, the final partial batch included
            # (vae_cf_train_val.py:172 end_idx=min(st+bs, N))
            for lo in range(0, n_train, bs):
                x = torch.from_numpy(
                    dense_rows(data.train, order[lo:lo + bs])).to(device)
                gen.manual_seed(step_seed(cfg.seed + 1, step))
                anneal = V.anneal_schedule(
                    step, cap=cfg.anneal_cap,
                    total_anneal_steps=cfg.total_anneal_steps)
                losses.append(float(train_step(params, opt_state, x, gen,
                                               anneal)))
                step += 1

            val = evaluate(params, data.vad_tr, data.vad_te)
            writer.write(step, epoch=epoch, loss=float(np.mean(losses)),
                         anneal=anneal, **val)
            log.info("epoch %d step %d loss %.4f val ndcg@100 %.4f",
                     epoch, step, float(np.mean(losses)), val["ndcg@100"])
            # best-NDCG retention (vae_cf_train_val.py:224-226)
            mgr.save(step, convert.export_params(params),
                     metric=val["ndcg@100"], extra={"epoch": epoch})
            if val["ndcg@100"] > best["ndcg"]:
                best = {"ndcg": val["ndcg@100"], "epoch": epoch}

    # restore-best-and-test (vae_cf_train_val.py:232-272)
    restored = mgr.restore(convert.export_params(params), best=True)
    if restored is None:
        raise RuntimeError(f"no best/ checkpoint under {cfg.model_dir}")
    best_tree, best_step, extra = restored
    test = evaluate(convert.convert_params(best_tree, device), data.test_tr,
                    data.test_te)
    log.info("test (best epoch %s): %s", extra.get("epoch"), test)
    return {
        "best_ndcg": best["ndcg"],
        "best_epoch": best["epoch"],
        "best_step": best_step,
        "test": test,
    }
