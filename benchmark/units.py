"""A model unit's device time a step, read from the port's unit marks in a
traced call's summary (`trace`): the mean over the steps of the union of
the intervals of the operations that start between the unit's opening and
closing marks, in the forward and in the backward, the marks' own time on
neither side.

The marks are the kernels ``recsys_unit_<unit>_forward``,
``_forward_end``, ``_backward`` and ``_backward_end``
(``recsys_tpu_torch/csrc/step_marks.cu``) that a captured step launches,
four a replay for each unit. Each side reads the mean over the stretches
the trace holds whole: the profiler can lose device records, and a stretch
that lost a mark is left out. Nothing is read where the trace holds no such
marks (a port without them), or where either side has fewer whole
stretches than nine in ten of the steps, or more than one a step.
"""

from __future__ import annotations

from benchmark import trace

UNIT = "recsys_unit_"


def _mark(name: str):
    return name[len(UNIT):].split("(")[0] if name.startswith(UNIT) else None


def stretches_us(s: dict, opening: str, closing: str) -> list[float]:
    """[µs of each whole stretch from an ``opening`` mark to the next
    ``closing`` mark], in start order; a stretch broken by another unit
    mark, or opened twice, is left out."""
    out, ops = [], None
    for name, start, end in sorted(s["device_ops"], key=lambda op: op[1]):
        mark = _mark(name)
        if mark == opening:
            ops = []                           # an open stretch is left out
        elif mark == closing and ops is not None:
            out.append(trace.union_us(ops))
            ops = None
        elif mark is not None:
            ops = None                         # another unit's mark
        elif ops is not None:
            ops.append((start, end))
    return out


def unit_ms(s: dict, unit: str) -> float | None:
    """Milliseconds a step of ``unit``'s forward and backward together."""
    ms = 0.0
    for side in ("forward", "backward"):
        whole = stretches_us(s, f"{unit}_{side}", f"{unit}_{side}_end")
        if not 0.9 * s["steps"] <= len(whole) <= s["steps"]:
            return None
        ms += sum(whole) / len(whole) / 1e3
    return ms
