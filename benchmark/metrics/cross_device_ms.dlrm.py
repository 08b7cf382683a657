"""cross_device_ms.dlrm (ms; layer: cross stack): milliseconds a step in
which the card ran an operation inside DLRM's low-rank cross stack, its
three layers' products and elementwise work: in the forward between the
port's unit marks ``cross_forward`` and ``cross_forward_end``, in the
backward between ``cross_backward`` (the stack's output gradient comes)
and ``cross_backward_end`` (its input gradient has gone), as
``benchmark/units.py`` reads a unit. Nothing read where the trace holds no
whole stretches of those marks."""

from benchmark import units


def read(s: dict):
    return units.unit_ms(s, "cross")
