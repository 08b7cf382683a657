"""Profiling (counterpart of ``recsys_tpu/utils/profiling.py``): where a
step's device time goes, by operation, with the place in the Python code
that launched each operation, and the name of the card a number was taken on.

`trace_step` runs a function once under ``torch.profiler`` (the CPU, and
CUDA where the work runs on a card) with Python stacks recorded;
`device_breakdown` sums the trace's device operations by name (on a card
the kernels, copies and fills; on the CPU its operators' own time);
`annotate_with_source` attaches to each the place in the port's code that
launched it, the port's counterpart of the JAX package's HLO metadata
(``annotate_with_hlo``); `print_breakdown` prints the table. The kernel
timings of ``tools/profile_step.py`` and ``chip_smoke.py`` read the same
device times (`device_time_us`).

The training path records into whatever profiler is on:

- `span`: a host span on the profiler's clock (``recsys.train.call`` around
  a K-step call, ``recsys.train.host_step`` around the host's part of each
  step);
- `mark`: a named kernel that does nothing (``csrc/step_marks.cu``),
  launched at each section boundary of a captured training step, `MARKS`.
  It is a node of the step's graph, so every replay runs it: in a device
  trace the marks cut each replayed step into its input, forward, backward
  and optimizer sections, which no host code can do. An eager step
  launches none. The bounds of a model's unit inside those sections,
  `UNIT_MARKS`, are marks too (DIN's attention units, DLRM's cross stack
  and bags, forward and backward; `backward_mark` places one in the
  backward);
- `DeviceCounter`: counts a captured step adds up on the card (DIN's
  attention rows and real history positions, DLRM's ids and touched
  rows), read by the host once a call and never inside one.
"""

from __future__ import annotations

import collections
import os
import subprocess
import threading

import torch
from torch._C._profiler import _RecordFunctionFast

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import I, P

#: the section boundaries of a training step, in order; mark ``m`` is the
#: kernel ``recsys_mark_<m>``
MARKS = ("begin", "forward", "backward", "optimizer", "end")
#: the four bounds of each unit of a model inside a step's sections, by
#: unit: DIN's attention units, DLRM's low-rank cross stack and its
#: embedding bags
UNITS = {unit: tuple(f"{unit}_{side}" for side in (
             "forward", "forward_end", "backward", "backward_end"))
         for unit in ("attention", "cross", "bags")}
#: every unit's bounds; mark ``u`` is the kernel ``recsys_unit_<u>``, a name
#: outside ``recsys_mark_``, so that a trace's split of a replay by `MARKS`
#: passes over it
UNIT_MARKS = tuple(m for marks in UNITS.values() for m in marks)
#: a mark's launch counts under ``mark`` (`cuda_build.launches`)
MARK_SOURCE = cuda_build.source("step_marks.cu", recsys_mark=[I, P],
                                recsys_unit_mark=[I, P])


def span(name: str):
    """``with span(name):`` records a host span ``name`` (``recsys.`` and a
    dotted path) into the profiler that is on, and costs a check when none
    is. Its scope is FUNCTION, as an operator's: the profiler keeps it on
    the host's track and mirrors nothing of it onto the card's, where a
    ``torch.profiler.record_function`` range would stand as a device
    operation over every kernel it encloses."""
    return _RecordFunctionFast(name)


def mark(name: str, like: torch.Tensor) -> None:
    """Launch the mark ``name`` (one of `MARKS` or `UNIT_MARKS`) into the
    graph that the current stream of ``like``'s device is capturing: one
    block of one thread that does nothing, named ``recsys_mark_<name>``
    (``recsys_unit_<name>``) in a device trace, which every replay of the
    graph runs. Outside a capture the mark launches nothing (an eager
    step's sections show in the host's trace, where a launch would cost
    each step); on CUDA it builds and loads the marks' library, as the
    warm-up step before a capture does. On a tensor that is not on CUDA,
    nothing."""
    if like.device.type != "cuda":
        return
    cuda_build.load(MARK_SOURCE)
    if name in MARKS:
        entry, which = "recsys_mark", MARKS.index(name)
    else:
        entry, which = "recsys_unit_mark", UNIT_MARKS.index(name)
    with torch.cuda.device(like.device):
        if not torch.cuda.is_current_stream_capturing():
            return
    cuda_build.launch(MARK_SOURCE, entry, like.device, which, counter="mark")


class _BackwardMark(torch.autograd.Function):
    """The identity on its tensors; its backward launches a mark once all
    of their gradients have come."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.mark_name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.mark_name, grads[0])
        return (None, *grads)


def backward_mark(name: str, *xs: torch.Tensor) -> tuple:
    """``xs`` unchanged (views of them), through a node of autograd whose
    backward launches the mark ``name`` (`mark`) once every gradient of
    ``xs`` has arrived, before the gradients go on: wrapped round a unit's
    outputs, the mark opens the unit's backward, round its inputs it
    closes it."""
    return _BackwardMark.apply(name, *xs)


class DeviceCounter:
    """Counts summed on the card: ``add(like, *values)`` adds one value a
    count (a Python int or an integer scalar tensor on ``like``'s device)
    into an int64 vector on that device, made at the first add (a graph's
    warm-up step, never inside its capture), so a captured step adds into
    it at every replay and nothing reads it back. `totals` reads a
    device's sums: the one host read, once a call and never inside one."""

    def __init__(self, names: tuple[str, ...]):
        self.names = tuple(names)
        self._sums: dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    def add(self, like: torch.Tensor, *values) -> None:
        if len(values) != len(self.names):
            raise ValueError(f"DeviceCounter: {len(values)} values for the "
                             f"counts {self.names}")
        sums = self.sums(like)
        for i, v in enumerate(values):
            sums[i].add_(v)

    def sums(self, like: torch.Tensor) -> torch.Tensor:
        """The int64 vector of the counts on ``like``'s device, in `names`'
        order (made at the first call), for a kernel to add into."""
        with self._lock:
            sums = self._sums.get(like.device)
            if sums is None:
                sums = self._sums[like.device] = torch.zeros(
                    (len(self.names),), dtype=torch.int64,
                    device=like.device)
        return sums

    def totals(self, device) -> dict[str, int] | None:
        """{count: its sum so far} on ``device`` (a host read), or None
        where nothing was added there."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        sums = self._sums.get(device)
        if sums is None:
            return None
        return dict(zip(self.names, sums.tolist()))


#: the H100 SXM's published peaks, the bounds the port's kernels and steps
#: are held to: device-memory bandwidth, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def card(device) -> str:
    """What a measurement on ``device`` ran on: on CUDA the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, else ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_time_us(evt) -> float:
    """The device time of a ``key_averages()`` entry, µs (the attribute's
    name differs between PyTorch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def trace_step(fn, *args, trace_dir: str | None = None):
    """Run ``fn(*args)`` once under ``torch.profiler`` with Python stacks,
    waiting for the card at the end → the profiler. With ``trace_dir``,
    its Chrome trace is written to ``trace_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, with_stack=True) as prof:
        fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return prof


def device_breakdown(prof, top: int | None = 15) -> list[dict]:
    """The ``top`` device operations of a trace by total time (all with
    ``top=None``), each ``{"op", "total_ms", "count", "device"}``. The
    device is the card where the trace holds CUDA work; else the CPU,
    whose operators are summed by their own time (a parent's children
    not counted twice)."""
    from torch.autograd import DeviceType

    averages = prof.key_averages()
    on_card = [e for e in averages if e.device_type == DeviceType.CUDA]
    if on_card:
        rows = [(device_time_us(e), e.count, e.key) for e in on_card]
        device = "cuda"
    else:
        rows = [(float(e.self_cpu_time_total), e.count, e.key)
                for e in averages if e.device_type == DeviceType.CPU]
        device = "cpu"
    rows.sort(key=lambda r: -r[0])
    return [{"op": key, "total_ms": us / 1e3, "count": count,
             "device": device}
            for us, count, key in (rows if top is None else rows[:top])]


def _source_of(evt) -> str | None:
    """Where ``evt`` was launched from in the port's code: the innermost
    frame of its recorded stack in a ``recsys_tpu_torch`` file, or (where
    the profiler records Python calls as events of their own) the
    innermost enclosing Python function there, as ``file(line): name``."""
    for entry in evt.stack or []:
        if "recsys_tpu_torch" in entry:
            return entry
    parent = evt.cpu_parent
    while parent is not None:
        if getattr(parent, "is_python_function", False) and \
                "recsys_tpu_torch" in parent.name:
            return parent.name
        parent = parent.cpu_parent
    return None


def annotate_with_source(rows: list[dict], prof) -> list[dict]:
    """Each row of `device_breakdown` gains ``source``: the place in the
    port's code that launched most of that operation's calls (`_source_of`
    the operator; on a card, of the operator whose launch the kernel is
    linked to). Operations launched outside the port's code, or from a
    thread without Python frames (autograd's backward), get None."""
    by_op: dict[str, collections.Counter] = collections.defaultdict(
        collections.Counter)
    for evt in prof.events():
        if getattr(evt, "is_python_function", False):
            continue
        line = _source_of(evt)
        if line is None:
            continue
        for name in [k.name for k in evt.kernels] or [evt.key]:
            by_op[name][line] += 1
    for row in rows:
        lines = by_op.get(row["op"])
        row["source"] = lines.most_common(1)[0][0] if lines else None
    return rows


def print_breakdown(rows: list[dict]) -> None:
    for r in rows:
        src = r.get("source") or ""
        print(f"{r['total_ms']:10.3f} ms  x{r['count']:5d}  "
              f"{r['op'][:48]:48s}  {src[:80]}")
