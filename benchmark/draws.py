"""Seeds: the benchmark's own, derived from ``--seed``, and the port's
per-step seed, worked out again so that the reference draws each step's
batch indices and dropout masks as the port's generator does.

Plain Python: imports nothing of the port.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15

#: streams of the benchmark's own draws from one ``--seed``
STREAMS = {"data": 1, "weights": 2}


def _mix(z: int) -> int:
    """splitmix64's finaliser of a 64-bit integer."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(seed: int, stream: str) -> int:
    """The 63-bit seed of the benchmark's ``stream`` ('data' or 'weights')
    in a run of ``--seed`` ``seed``: a generator seeded with it never draws
    what the port's own generator draws."""
    return _mix((seed * _GOLDEN + (STREAMS[stream] << 40)) & _MASK64) >> 1


def step_seed(seed: int, step: int) -> int:
    """The seed the port gives its train state's generator before step
    ``step`` of a run seeded with ``seed`` (a splitmix64 mix of the pair,
    ``recsys_tpu_torch/train/train_state.py`` ``step_seed``): the port
    draws the step's batch indices and then its dropout masks from it."""
    return _mix((seed * _GOLDEN + step) & _MASK64) >> 1
