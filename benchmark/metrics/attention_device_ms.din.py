"""attention_device_ms.din (ms; layer: attention units): milliseconds a step
in which the card ran an operation inside DIN's two attention units: in the
forward between the port's unit marks ``attention_forward`` and
``attention_forward_end``, in the backward between ``attention_backward``
(the units' output gradients come) and ``attention_backward_end`` (their
input gradients have gone), each the union of the intervals of the
operations that start between the two marks (the marks' own time on
neither side).

The marks are the kernels ``recsys_unit_<mark>``
(``recsys_tpu_torch/csrc/step_marks.cu``) that a captured DIN step
launches, four a replay. The forward and the backward each read the mean
over the stretches the trace holds whole: the profiler can lose device
records, and a stretch that lost a mark is left out. Nothing read where the
trace holds no unit marks (a port without them), or where either side has
fewer whole stretches than nine in ten of the steps, or more than one a
step."""

from benchmark import trace

UNIT = "recsys_unit_"
#: (opening mark, closing mark) of the forward and of the backward
SIDES = (("attention_forward", "attention_forward_end"),
         ("attention_backward", "attention_backward_end"))


def _mark(name: str):
    return name[len(UNIT):].split("(")[0] if name.startswith(UNIT) else None


def stretches_us(s: dict, opening: str, closing: str):
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
            ops = None                         # a mark of the other side
        elif ops is not None:
            ops.append((start, end))
    return out


def read(s: dict):
    ms = 0.0
    for opening, closing in SIDES:
        whole = stretches_us(s, opening, closing)
        if not 0.9 * s["steps"] <= len(whole) <= s["steps"]:
            return None
        ms += sum(whole) / len(whole) / 1e3
    return ms
