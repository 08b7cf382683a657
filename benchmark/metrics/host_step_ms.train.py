"""host_step_ms.train (ms; layer: K-step call): milliseconds a step of the
host's own part of each step in the traced call, the port's
``recsys.train.host_step`` spans (``recsys_tpu_torch/train/fast.py``
``_run``: the generator's reseed, or the copy of a step's indices or
batch). Nothing read where the trace holds no such span, or other than one
a step."""

SPAN = "recsys.train.host_step"


def read(s: dict):
    spans = [(a, b) for name, a, b in s["host_ops"] if name == SPAN]
    if not spans or len(spans) != s["steps"]:
        return None
    return sum(b - a for a, b in spans) / 1e3 / s["steps"]
