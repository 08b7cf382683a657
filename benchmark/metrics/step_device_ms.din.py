"""step_device_ms.din (ms; layer: train step): milliseconds a DIN step in
which the card ran an operation, the union of the device operations'
intervals of the traced call over its steps: ``step_device_ms.train``'s
reading of the DIN cell's summary."""

from benchmark import spec

_step_ms = spec.metric_reader("step_device_ms.train")


def read(s: dict):
    return _step_ms(s)
