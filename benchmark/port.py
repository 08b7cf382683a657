"""The system under test: the port's model, train state and graphed K-step
call (``recsys_tpu_torch.train.fast.make_scanned_train_step_devgen``), built
from a configuration file as ``tools/train_ctr.py train`` builds them, with
the benchmark's weights put in place of the port's own draws.

The only module of the benchmark that imports the port.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import cin_kernel, cuda_build, row_gather, segment_sum
from recsys_tpu_torch.train import fast, optim
from recsys_tpu_torch.train import train_state as TS


def model(config: dict):
    """The port's model of ``config``."""
    criteo = CriteoConfig(
        cont_boundaries=tuple(tuple(b) for b in config["cont_boundaries"]),
        cat_vocabs=tuple(config["cat_vocabs"]))
    cfg = ModelConfig(
        name=config["model"], embedding_dim=config["embedding_dim"],
        deep_layers=tuple(config["deep_layers"]),
        cin_layers=tuple(config.get("cin_layers", ModelConfig.cin_layers)),
        dropout=config["dropout"], use_bn=config["use_bn"],
        compute_dtype=config["dtype"], emb_engine=config["emb_engine"],
        split_threshold=config["split_threshold"])
    return make_model(config["model"], criteo, cfg)


def templates(m):
    """(parameter tree, model state tree) of ``m`` on the 'meta' device:
    shapes, no values."""
    return m.init(torch.Generator(), "meta")


def model_state(template, device):
    """The model state a new model starts from: batch norm's moving mean 0
    and variance 1 (``ops/nn.py`` ``bn_init``), shaped as ``template``."""
    if isinstance(template, dict):
        return {k: (torch.zeros if k == "mean" else torch.ones)(
                    v.shape, dtype=v.dtype, device=device)
                if k in ("mean", "var") else model_state(v, device)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [model_state(v, device) for v in template]
    raise ValueError(f"model state leaf of unknown kind: {template!r}")


def build_kernels() -> None:
    """Build (or find built, by the sources' hash) every kernel a training
    step reaches, all at once: a new checkout builds them here, in
    set-up."""
    cuda_build.build_all([row_gather.SOURCE, segment_sum.SOURCE,
                          cin_kernel.SOURCE, cin_kernel.BWD_SOURCE])


def train_state(m, config: dict, params, model_state, seed: int, device):
    """(TrainState, optimizer) as ``train_state.create_train_state`` makes
    them, with ``params`` and ``model_state`` in place of its own draws."""
    tx = optim.for_model(m.meta, config["optimizer"]["learning_rate"])
    ts = TS.TrainState(params, model_state, tx.init(params),
                       torch.zeros((), dtype=torch.int32, device=device),
                       TS.make_generator(seed + 1, device), seed)
    return ts, tx


def step_fn(m, tx, n_rows: int, batch: int):
    """The K-step call the training loop drives:
    ``steps(ts, data, k, first_step) -> (ts, mean loss)``."""
    return fast.make_scanned_train_step_devgen(m, tx, n_rows, batch)

