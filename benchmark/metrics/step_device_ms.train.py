"""step_device_ms.train (ms; layer: train step): milliseconds a step in
which the card ran an operation, the union of the device operations'
intervals of the traced call over its steps."""


def read(s: dict):
    return s["busy_s"] * 1e3 / s["steps"] if s["device_ops"] else None
