"""The readers of the port's step marks and host spans on a summary made by
hand: two replays, each cut by its five marks, with gaps inside them and
the generator's fills between them."""

import pytest

from benchmark import spec, trace

K = 2     # steps in the slice
MARKS = ("begin", "forward", "backward", "optimizer", "end")
#: one replay from its start: (name, start µs, end µs); marks take 1 µs
REPLAY = [("recsys_mark_begin", 0, 1),
          ("index_random", 1, 3), ("row_gather_kernel<float>", 3, 6),
          ("recsys_mark_forward", 6, 7),
          ("gemm", 7, 17), ("relu", 19, 21),                # a 2 µs gap
          ("recsys_mark_backward", 21, 22),
          ("gemm_bwd", 22, 40), ("segment_chunks", 40, 44),
          ("recsys_mark_optimizer", 44, 45),
          ("adam_add", 45, 60), ("copy", 61, 63),           # a 1 µs gap
          ("recsys_mark_end", 63, 64)]
#: µs a step of each section, of the gaps inside a replay, of the marks
SECTION_US = {"input": 5, "forward": 12, "backward": 22, "optimizer": 17}
GAP_US, MARKS_US = 3, 5
#: the two fills before each replay: 3 µs a step
FILLS = [("fill", 0, 2), ("fill", 4, 5)]


def _summary(steps=K, drop=None, marks=True, lost=None):
    """One replay a step, 100 µs apart and each after its fills; ``drop``:
    the name of a device operation left out of the second replay; without
    ``marks``, the trace of a port that launches none; ``lost(i, name)``:
    whether the profiler lost operation ``name`` of replay ``i``."""
    device = []
    for i in range(steps if lost else K):
        t0 = 100 * i
        device += [(n, t0 + a, t0 + b) for n, a, b in FILLS]
        device += [(n, t0 + 10 + a, t0 + 10 + b) for n, a, b in REPLAY
                   if not (i == 1 and n == drop)
                   and not (lost and lost(i, n))
                   and (marks or not n.startswith("recsys_mark_"))]
    host = [("recsys.train.call", 0.0, 180.0),
            ("recsys.train.host_step", 0.0, 3.0),
            ("recsys.train.host_step", 100.0, 104.0),
            ("aten::fill_", 0.0, 2.5), ("cudaGraphLaunch", 6.0, 9.0),
            ("cudaGraphLaunch", 106.0, 109.0)]
    return trace.summarize(device, host, 200e-6, steps)


def _read(metric, s):
    return spec.metric_reader(metric)(s)


@pytest.mark.parametrize("metric, value", [
    ("input_device_ms.train", SECTION_US["input"] / 1e3),
    ("forward_device_ms.train", SECTION_US["forward"] / 1e3),
    ("backward_device_ms.train", SECTION_US["backward"] / 1e3),
    ("optimizer_device_ms.train", SECTION_US["optimizer"] / 1e3),
    ("replay_gap_ms.train", GAP_US / 1e3),
    ("host_step_ms.train", (3.0 + 4.0) / 2 / 1e3),
])
def test_readers(metric, value):
    assert _read(metric, _summary()) == pytest.approx(value)


def test_the_sections_the_marks_and_the_fills_make_the_step():
    s = _summary()
    sections = sum(_read(f"{name}_device_ms.train", s) for name in SECTION_US)
    marks, fills = MARKS_US / 1e3, trace.union_us(
        (a, b) for _, a, b in FILLS) / 1e3
    assert sections + marks + fills == pytest.approx(
        _read("step_device_ms.train", s))


GROUPED = ["input_device_ms.train", "forward_device_ms.train",
           "backward_device_ms.train", "optimizer_device_ms.train",
           "replay_gap_ms.train"]


@pytest.mark.parametrize("metric", GROUPED)
@pytest.mark.parametrize("summary", [
    pytest.param(lambda m=m: _summary(drop=f"recsys_mark_{m}"), id=f"no-{m}")
    for m in MARKS] + [
    pytest.param(lambda: _summary(steps=K + 1), id="steps-other-than-groups"),
    pytest.param(lambda: _summary(marks=False), id="no-marks"),
])
def test_nothing_read_without_a_whole_replay_a_step(metric, summary):
    assert _read(metric, summary()) is None


#: the ops of the first replay before its ``optimizer`` mark, which the
#: profiler lost at the head of a traced call on the card
HEAD = {n for n, _, _ in REPLAY[:REPLAY.index(
    ("recsys_mark_optimizer", 44, 45))]}


@pytest.mark.parametrize("metric", GROUPED)
@pytest.mark.parametrize("lost, whole", [
    (lambda i, n: i == 0 and n in HEAD, True),
    (lambda i, n: i == 4 and n == "recsys_mark_forward", True),
    (lambda i, n: i == 7 and n == "recsys_mark_end", True),
    (lambda i, n: i in (3, 4) and n == "recsys_mark_backward", False),
], ids=["head-of-the-first", "a-forward-mark", "an-end-mark",
        "two-replays"])
def test_a_replay_the_trace_lost_in_part_is_left_out(metric, lost, whole):
    """Ten steps: one replay lost in part leaves nine whole, read as the
    whole trace reads; two leave eight, fewer than nine in ten: nothing."""
    s = _summary(steps=10, lost=lost)
    value = _read(metric, _summary(steps=10, lost=lambda i, n: False))
    assert _read(metric, s) == (pytest.approx(value) if whole else None)
    assert value == pytest.approx(_read(metric, _summary()))


def test_marks_out_of_order_read_nothing():
    s = _summary()
    swap = {"recsys_mark_forward": "recsys_mark_backward",
            "recsys_mark_backward": "recsys_mark_forward"}
    s["device_ops"] = [(swap.get(n, n), a, b) for n, a, b in s["device_ops"]]
    assert all(_read(metric, s) is None for metric in GROUPED)


def test_host_steps_read_nothing_unless_one_a_step():
    s = _summary()
    s["host_ops"] = [op for op in s["host_ops"]
                     if op[0] != "recsys.train.host_step"]
    assert _read("host_step_ms.train", s) is None
    assert _read("host_step_ms.train", _summary(steps=K + 1)) is None


def test_the_call_span_names_every_gap_inside_the_call():
    gaps = trace.breakdown(_summary())["idle_gaps"]
    assert gaps and all(name != "no host operation traced"
                        for name, _ in gaps)
