"""attention_roofline.din (%; layer: attention units): DIN's two attention
units' share of their roofline: a step's bound (``benchmark/models/din.py``
``attention_work``: the dense layers' flops at every history position,
forward and backward, and the least bytes the units move; the larger of
flops over 67 TFLOP/s and bytes over 3.35 TB/s) over the units' device time
a step (``attention_device_ms.din``). Nothing read where that reads
nothing."""

from benchmark import spec, trace

_attention_ms = spec.metric_reader("attention_device_ms.din")


def read(s: dict):
    ms = _attention_ms(s)
    work = s["work"].get("attention")
    if not ms or not work:
        return None
    bound = sum(trace.bound_s(b, f) for b, f in work)
    return 100.0 * bound / (ms / 1e3)
