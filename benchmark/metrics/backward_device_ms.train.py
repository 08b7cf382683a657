"""backward_device_ms.train (ms; layer: train step): milliseconds a step in
which the card ran an operation between a replay's ``backward`` and
``optimizer`` marks: autograd's backward, the embedding gradients' segment sums
among it (the union of their intervals; the marks' own time is on no section's
side). A mean over the replays the trace holds whole; nothing read where it
holds too few (``replay_gap_ms.train``'s ``replays``)."""

from benchmark import spec

#: the replays' grouping, in ``replay_gap_ms.train``'s reader
_section_ms = spec.metric_reader("replay_gap_ms.train").__globals__[
    "section_ms"]


def read(s: dict):
    return _section_ms(s, "backward", "optimizer")
