"""mfu.din (%; layer: train step): DIN's whole step's share of the card's
float32 peak: the model's flops an example (``benchmark/models/din.py``
``forward_flops``: the two attention units' dense layers at every one of
the 128 history positions, padded or not, and the MLP's; the backward twice
the forward) times the examples a second of the run's untraced window,
over 67 TFLOP/s (``benchmark/peaks.json``): ``mfu.train``'s reading of the
DIN cell's summary."""

from benchmark import spec

_mfu = spec.metric_reader("mfu.train")


def read(s: dict):
    return _mfu(s)
