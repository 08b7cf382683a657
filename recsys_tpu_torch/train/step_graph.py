"""One step of a K-step call captured as a CUDA graph and replayed once a
step: the port's counterpart of the JAX package's one XLA program per K
steps (``recsys_tpu/train/fast.py``, ``lax.scan`` under ``jit``).

A training step of the Criteo zoo is 100 to 500 small kernels. Enqueued
from Python one by one, they cost the host more time than they cost the
card. Captured once, the step replays as one ``cudaGraphLaunch``.

The graph holds one step, not K: the loops reseed the train state's
generator from (seed, step) on the host before every step
(`train_state.reseed`), which cannot happen inside a graph. The generator
is registered with the graph, so each replay reads the generator's
current seed and offset: before its launch, the replay writes them into
the graph's copies on the card with two fills on the current stream,
outside the graph (three host launches a step with the graph's own). A
replay after ``reseed(ts, s)`` therefore draws what the eager step ``s``
draws.

`StepGraph` keeps what the capture needs:

- **Warm-up.** The first step of a capture runs eagerly, as a real step,
  on the side stream that then captures it. It builds the kernels, fills
  the per-device caches (offsets, index constants, the segment sum's
  workspace sizes) and sets the kernels' one-time attributes, none of
  which may happen inside a capture.
- **Identity.** A graph writes into the addresses it captured. It is
  keyed by every tensor it reads or writes (address, shape, strides,
  type) and every other object it uses (the generator); a call with other
  storage recaptures. The graph holds references to what it was captured
  on, so no other tensor can take over those addresses while it lives.
- **Memory.** The graph's private memory pool goes with it: with a
  recapture, or when the scanned function that owns it is dropped.
- **Launch counts.** The kernel wrappers count launches in Python, which
  a replay does not run. The counts a capture adds are taken back, and
  added again at every replay, so the counters count launches that ran.
  The capture learns its own counts from the tally of the stream it
  captures on (`cuda_build.launch_tally`; autograd's backward launches
  reach that stream from autograd's own thread), so launches that other
  threads count meanwhile on their streams (a server's other requests)
  stay theirs.
- **Other threads.** The capture fails only the capturing thread's
  unsafe calls, so the prefetcher's transfer thread may keep copying on
  its own stream while a step is captured.
- **No fallback.** A capture or replay that fails raises, naming the
  step; nothing runs the eager loop in its place.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import (adam_update, cin_kernel, cuda_build,
                                  din_attention, row_gather, segment_sum)

#: (module, name) of the counters of every kernel wrapper a training or
#: eval step reaches: launches, and the leaves Adam's launches covered
COUNTERS = ((segment_sum, "LAUNCHES"), (row_gather, "LAUNCHES"),
            (cin_kernel, "LAUNCHES"), (cin_kernel, "BWD_LAUNCHES"),
            (adam_update, "LAUNCHES"), (adam_update, "LEAVES"),
            (din_attention, "LAUNCHES"))


def _tallied(tally: dict) -> list[int]:
    """The launches of each of `COUNTERS` in a `cuda_build.launch_tally`."""
    return [tally.get(f"{m.__name__}.{name}", 0) for m, name in COUNTERS]


def _add_counts(deltas) -> None:
    for (m, name), d in zip(COUNTERS, deltas):
        if d:
            with m._count_lock:
                setattr(m, name, getattr(m, name) + d)


def use_graph(graphed: bool | None, device: torch.device, name: str) -> bool:
    """Whether ``name`` replays a graph on ``device``: ``graphed`` if given,
    else on CUDA only. ``graphed=True`` off CUDA raises."""
    if graphed is None:
        return device.type == "cuda"
    if graphed and device.type != "cuda":
        raise ValueError(f"{name}: graphed=True needs CUDA tensors, the "
                         f"data is on {device}")
    return graphed


def signature(obj):
    """What a graph captured of ``obj``: each tensor's address, shape,
    strides, type and device, each dict's keys, each integer's value,
    each other object's identity (a generator)."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.data_ptr(), tuple(obj.shape), obj.stride(),
                obj.dtype, obj.device)
    if isinstance(obj, dict):
        return tuple((k, signature(obj[k])) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(signature(v) for v in obj)
    if isinstance(obj, int):
        return obj
    return ("object", id(obj))


class StepGraph:
    """The captured graph of one step of the scanned function ``name``."""

    def __init__(self, name: str):
        self.name = name
        self._graph = None
        self._key = None
        self._held = None
        self._deltas: list[int] = []
        #: the tensors the captured step reads and writes besides ``held``
        #: (index buffer, loss sum, metric state), set by `capture`
        self.static = None

    def static_for(self, held):
        """``static`` of the graph captured on ``held``, or None when there
        is none (no capture yet, or one on other storage)."""
        if self._graph is None or self._key != signature(held):
            return None
        return self.static

    def reset(self) -> None:
        """Drop the graph, its memory pool and what it holds."""
        self._graph = self._key = self._held = self.static = None

    def capture(self, held, static, step, generators=()) -> None:
        """Run ``step()`` once eagerly (the warm-up, a real step), then
        capture it; both on one side stream. ``held`` is everything the
        step reads or writes besides ``static`` (the graph's key);
        ``generators`` are those its random draws use."""
        self.reset()
        device = static[0].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            step()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        # as torch.cuda.graph does, without its stream left behind when
        # the capture fails: free the cache, then capture on the side
        # stream. The capture mode is thread_local: another thread's CUDA
        # calls (`loader.device_prefetch` allocating, copying and waiting
        # on events on its own stream) go on during the capture, where the
        # default global mode would fail them and break the capture.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        try:
            with cuda_build.launch_tally(side.cuda_stream) as tally, \
                    torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: "
                               f"{e}") from e
        finally:
            deltas = _tallied(tally)
            _add_counts([-d for d in deltas])     # the capture ran nothing
        self._graph, self._key, self._held = graph, signature(held), held
        self.static, self._deltas = static, deltas

    def replay(self) -> None:
        """One step: the graph's replay on the current stream."""
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: CUDA graph replay failed: "
                               f"{e}") from e
        _add_counts(self._deltas)
