"""mfu.dlrm (%; layer: train step): DLRM's whole step's share of the card's
float32 peak: the model's flops an example (``benchmark/models/dlrm.py``
``forward_flops``: the bottom MLP, the three low-rank cross layers and the
top MLP, 32.06 MFLOP at the configuration's widths; the backward twice the
forward; the bags, the elementwise work and the optimizer none) times the
examples a second of the run's untraced window, over 67 TFLOP/s
(``benchmark/peaks.json``): ``mfu.train``'s reading of the DLRM cell's
summary."""

from benchmark import spec

_mfu = spec.metric_reader("mfu.train")


def read(s: dict):
    return _mfu(s)
