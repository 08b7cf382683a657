"""Step factories (counterpart of ``recsys_tpu/train/train_state.py``).

Only the predict step is ported; the train and eval steps come with the
training path.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.models.api import Model


def make_predict_step(model: Model):
    """``predict(params, model_state, batch) -> probs`` [B] — the serving
    signature: sigmoid of the eval-mode logits."""

    def predict(params, model_state, batch):
        logits, _ = model.apply(params, model_state, batch, train=False)
        return torch.sigmoid(logits)

    return predict
