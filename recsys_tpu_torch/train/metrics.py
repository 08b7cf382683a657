"""Streaming binary-classification metrics (counterpart of the AUC /
accuracy / logloss part of ``recsys_tpu/train/metrics.py``).

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
