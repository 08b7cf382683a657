"""The system under test in the DLRM cell: the port's ``dlrm_dcnv2`` model
(``recsys_tpu_torch/models/dlrm.py``) built through
``models.api.make_model`` at the configuration's widths and the rows this
card holds, its train state with the optimizer the model declares
(``optim.for_model``: row-wise Adagrad on the table, Adagrad on the dense
leaves, ε 1e-8), the kernels its step reaches, and what it counts on the
card. The graphed K-step call is `port`'s, as in the other cells.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import cuda_build, row_gather, rowwise_adagrad
from recsys_tpu_torch.ops import segment_sum
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling


def model(config: dict):
    """The port's DLRM-DCNv2 of ``config``."""
    over = config["over_arch_layer_sizes"]
    if over[-1] != 1:
        raise ValueError(f"dlrm: the over arch ends at {over[-1]}, not 1")
    return make_model(
        "dlrm_dcnv2", tuple(config["num_embeddings_per_feature"]),
        tuple(config["multi_hot_sizes"]),
        embedding_dim=config["embedding_dim"],
        num_dense=config["num_dense_features"],
        bottom_layers=tuple(config["dense_arch_layer_sizes"]),
        top_layers=tuple(over[:-1]), cross_layers=config["dcn_num_layers"],
        cross_rank=config["dcn_low_rank_dim"],
        init_rows=tuple(config["published_num_embeddings_per_feature"]))


def build_kernels() -> None:
    """Build (or find built) every kernel a DLRM training step reaches, all
    at once, in set-up."""
    cuda_build.build_all([row_gather.SOURCE, segment_sum.SOURCE,
                          rowwise_adagrad.SOURCE, profiling.MARK_SOURCE])


def train_state(m, config: dict, params, seed: int, device):
    """(TrainState, optimizer) as ``train_state.create_train_state`` makes
    them, with ``params`` in place of the port's own draws."""
    tx = optim.for_model(m.meta, config["learning_rate"])
    ts = TS.TrainState(params, {}, tx.init(params),
                       torch.zeros((), dtype=torch.int32, device=device),
                       TS.make_generator(seed + 1, device), seed)
    return ts, tx


def bag_counts(m, device) -> dict | None:
    """{'ids', 'unique'} that the model's bags have counted on ``device``
    so far (one host read), or None where the port counts none."""
    counter = m.meta.get("bag_counter")
    return None if counter is None else counter.totals(device)
