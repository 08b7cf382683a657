"""mfu.train (%; layer: train step): the whole step's share of the card's
float32 peak: the model's flops an example (forward, 2 per multiply-add of
the dense layers, the FM term and the CIN; the backward twice the forward;
lookups and the optimizer none: ``benchmark/models/<model>.py``
``forward_flops``) times the examples a second of the run's untraced
window, over 67 TFLOP/s (``benchmark/peaks.json``)."""

from benchmark import trace


def read(s: dict):
    if not s["device_ops"]:
        return None
    flops = 3.0 * s["flops_per_example"] * s["examples_per_s"]
    return 100.0 * flops / trace.peaks()["fp32_flops_per_s"]
