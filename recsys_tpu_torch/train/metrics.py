"""Evaluation metrics (counterpart of ``recsys_tpu/train/metrics.py``):
the streaming binary-classification metrics, then the ranking metrics of
the CF family (NDCG@k and Recall@k on the device, SuccessRate@N and the
normalized cross-entropy in numpy).

``tf.metrics.auc`` integrates 200 linear thresholds with the trapezoid rule;
a 200-bin histogram of the predicted probabilities per label gives the same
estimate. The state is a few tensors on the eval device; `update` is plain
tensor ops there and never reads back to the host, and `finalize` reads it
once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_NUM_BINS = 200


class BinaryMetricState(NamedTuple):
    pos_hist: torch.Tensor   # [num_bins] positive-label predictions per bin
    neg_hist: torch.Tensor   # [num_bins]
    count: torch.Tensor      # scalar, examples seen
    loss_sum: torch.Tensor   # scalar, Σ per-example sigmoid CE
    correct: torch.Tensor    # scalar, Σ (round(p) == y)


def init_binary_metrics(num_bins: int = DEFAULT_NUM_BINS,
                        device="cpu") -> BinaryMetricState:
    z = torch.zeros((num_bins,), dtype=torch.float32, device=device)
    s = torch.zeros((), dtype=torch.float32, device=device)
    return BinaryMetricState(z, z.clone(), s, s.clone(), s.clone())


def sigmoid_ce_per_example(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """max(x, 0) − x·y + log1p(exp(−|x|)): stable sigmoid cross-entropy
    (``tf.nn.sigmoid_cross_entropy_with_logits``)."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def update_binary_metrics(state: BinaryMetricState, logits: torch.Tensor,
                          labels: torch.Tensor) -> BinaryMetricState:
    """The state after one batch of [B] logits and {0, 1} labels."""
    num_bins = state.pos_hist.shape[0]
    labels = labels.to(torch.float32)
    probs = torch.sigmoid(logits)
    bins = (probs * num_bins).to(torch.int64).clamp_(0, num_bins - 1)
    pos_hist = state.pos_hist.index_add(0, bins, labels)
    neg_hist = state.neg_hist.index_add(0, bins, 1.0 - labels)
    ce = sigmoid_ce_per_example(logits, labels)
    return BinaryMetricState(
        pos_hist, neg_hist,
        state.count + labels.shape[0],
        state.loss_sum + ce.sum(),
        state.correct + (torch.round(probs) == labels).sum())


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """The exact ROC AUC of ``scores`` against {0, 1} ``labels`` on the host:
    the Mann-Whitney statistic, ties at half (what
    ``sklearn.metrics.roc_auc_score`` computes; scikit-learn is not needed)."""
    labels = np.asarray(labels) > 0.5
    scores = np.asarray(scores, np.float64)
    _, inv, counts = np.unique(scores, return_inverse=True,
                               return_counts=True)
    # the mean rank of each distinct value, given to each of its ties
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inv]
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def finalize_binary_metrics(state: BinaryMetricState) -> dict[str, float]:
    """Trapezoidal ROC-AUC from the histograms + running means."""
    pos = state.pos_hist.detach().cpu().numpy().astype(np.float64)
    neg = state.neg_hist.detach().cpu().numpy().astype(np.float64)
    # sweep the threshold from high to low: cumulative sums from the top bin
    tp = np.concatenate([[0.0], np.cumsum(pos[::-1])])
    fp = np.concatenate([[0.0], np.cumsum(neg[::-1])])
    tpr = tp / max(pos.sum(), 1.0)
    fpr = fp / max(neg.sum(), 1.0)
    count = float(state.count)
    return {
        "auc": float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2)),
        "accuracy": float(state.correct) / max(count, 1.0),
        "logloss": float(state.loss_sum) / max(count, 1.0),
        "count": count,
    }


# ---------------------------------------------------------------------------
# Ranking metrics (counterpart of the VAE-CF half of
# ``recsys_tpu/train/metrics.py``; vae_cf_train_val.py:84-118)
# ---------------------------------------------------------------------------

def ndcg_at_k(scores: torch.Tensor, heldout: torch.Tensor,
              k: int = 100) -> torch.Tensor:
    """NDCG@k per user, binary relevance.

    ``scores``: [U, I] predicted scores with the train items already masked
    to -inf by the caller; ``heldout``: [U, I] binary held-out matrix on
    the same device. DCG over the top-k ranked items with 1/log2(rank+2)
    gains; IDCG is the cumulative discount indexed at min(#heldout, k).
    `torch.topk` may order ties (the -inf entries among them) otherwise
    than ``lax.top_k``; that changes nothing while a user's fold-in and
    held-out items are disjoint."""
    _, top_idx = torch.topk(scores, k, dim=1)                 # [U, k]
    gains = torch.gather(heldout, 1, top_idx)                 # [U, k]
    discounts = 1.0 / torch.log2(torch.arange(
        2, k + 2, dtype=torch.float32, device=scores.device))
    dcg = torch.sum(gains * discounts, dim=1)
    n_capped = torch.clamp(torch.sum(heldout, dim=1).to(torch.int64), max=k)
    ideal_cum = torch.cat([discounts.new_zeros(1), torch.cumsum(discounts, 0)])
    idcg = ideal_cum[n_capped]
    return dcg / torch.clamp(idcg, min=1e-10)


def recall_at_k(scores: torch.Tensor, heldout: torch.Tensor,
                k: int = 20) -> torch.Tensor:
    """Recall@k per user: |top-k ∩ heldout| / min(k, |heldout|)."""
    _, top_idx = torch.topk(scores, k, dim=1)
    hits = torch.sum(torch.gather(heldout, 1, top_idx), dim=1)
    n_heldout = torch.sum(heldout, dim=1)
    return hits / torch.clamp(torch.clamp(n_heldout, max=float(k)),
                              min=1e-10)


def success_rate_at_n(pred_topn: np.ndarray, true_mat: np.ndarray) -> float:
    """CDAE SuccessRate@N (cade/metrics.py:3-10): % of users whose top-N
    predictions intersect the true held-out set."""
    cnt = 0
    for i in range(pred_topn.shape[0]):
        true_items = np.where(true_mat[i] == 1)[0]
        if np.intersect1d(pred_topn[i], true_items).size > 0:
            cnt += 1
    return cnt * 100.0 / pred_topn.shape[0]


def normalized_cross_entropy(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """NCE (gbdt_lr.py:124-127): logloss normalized by the entropy of the
    base rate."""
    y_true = np.asarray(y_true, np.float64)
    y_prob = np.clip(np.asarray(y_prob, np.float64), 1e-15, 1 - 1e-15)
    ll = -np.mean(y_true * np.log(y_prob) + (1 - y_true) * np.log(1 - y_prob))
    p = float(np.clip(y_true.mean(), 1e-15, 1 - 1e-15))  # degenerate base rate
    base = -(p * np.log(p) + (1 - p) * np.log(1 - p))
    return float(ll / base)
