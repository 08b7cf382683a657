"""replay_gap_ms.train (ms; layer: device): milliseconds a step, inside the
replays of the traced call, in which the card ran nothing: each replay from
its ``begin`` mark's start to its ``end`` mark's end, less the union of the
device operations in it, marks included. The gaps between the kernels of
one replay, where the gaps between replays, their fills and the call's cold
start are not.

The marks are the port's named no-op kernels ``recsys_mark_<section>``
(``recsys_tpu_torch/csrc/step_marks.cu``), launched into each training
step at its section boundaries. `replays` and `section_ms` are shared with
the readers of the sections (``<section>_device_ms.train``). Each reads a
mean over the replays the trace holds whole: the profiler can lose device
records, most often the head of the traced call's first replay, and a
replay that lost a mark is left out. Nothing read where the trace holds no
marks, or fewer whole replays than nine in ten of the steps, or more than
one a step."""

from benchmark import trace

MARK = "recsys_mark_"
#: the marks of a step, in order
SECTIONS = ("begin", "forward", "backward", "optimizer", "end")


def _mark(name: str):
    """The section of a mark's device operation, or None for any other."""
    return name[len(MARK):].split("(")[0] if name.startswith(MARK) else None


def replays(s: dict):
    """The traced call's whole replays: from each ``begin`` mark to the next
    ``end`` mark in start order, as ({section: its mark's (start, end)},
    [(start, end) of each other operation]). A group that lacks a mark, or
    holds one twice or out of order, is left out, and so are the operations
    between groups. None unless there are at least nine whole groups in
    ten of ``s["steps"]`` and no more than ``s["steps"]``."""
    groups, marks, ops = [], None, []
    for name, start, end in sorted(s["device_ops"], key=lambda op: op[1]):
        section = _mark(name)
        if section == "begin":
            marks, ops = {}, []                 # an open group is left out
        if marks is None:
            continue                            # between replays
        if section is None:
            ops.append((start, end))
        elif section != SECTIONS[len(marks)]:
            marks = None                        # a mark lost or repeated
        else:
            marks[section] = (start, end)
            if section == "end":
                groups.append((marks, ops))
                marks = None
    if not 0.9 * s["steps"] <= len(groups) <= s["steps"]:
        return None
    return groups


def section_ms(s: dict, first: str, last: str):
    """Milliseconds a replay in which the card ran an operation that started
    after mark ``first`` and before mark ``last``, over the whole
    replays."""
    groups = replays(s)
    if groups is None:
        return None
    us = sum(trace.union_us((a, b) for a, b in ops
                            if marks[first][0] < a < marks[last][0])
             for marks, ops in groups)
    return us / 1e3 / len(groups)


def read(s: dict):
    groups = replays(s)
    if groups is None:
        return None
    idle = sum(marks["end"][1] - marks["begin"][0]
               - trace.union_us(list(marks.values()) + ops)
               for marks, ops in groups)
    return idle / 1e3 / len(groups)
