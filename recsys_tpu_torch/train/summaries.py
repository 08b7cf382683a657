"""Training scalars (counterpart of ``recsys_tpu/train/summaries.py``).

An append-only JSONL stream under ``model_dir``, one record per event:
``{"step": N, "wall_time": t, "<tag>": value, ...}``; `read_scalars` loads
it back. The same events tee into a TensorBoard event file in the same
directory (`train.tb_events.EventWriter`), so ``tensorboard --logdir
<model_dir>`` opens a port run as it opens a JAX one. ``tb=False`` turns
the tee off.
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    """Append-only JSONL scalar stream, flushed per event; tees into a
    TensorBoard event file unless ``tb=False``."""

    def __init__(self, model_dir: str, filename: str = "scalars.jsonl",
                 tb: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, filename)
        self._f = open(self.path, "a")
        self._tb = None
        if tb:
            from recsys_tpu_torch.train.tb_events import EventWriter
            self._tb = EventWriter(model_dir)

    def write(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "wall_time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalars({k: float(v) for k, v in scalars.items()},
                                 step)
            self._tb.flush()

    def write_histogram(self, step: int, tag: str, values) -> None:
        """Histogram events go to the TB file only (the reference's
        tf.summary.histogram analog, vae_cf_model.py:60-62)."""
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(model_dir: str,
                 filename: str = "scalars.jsonl") -> list[dict]:
    path = os.path.join(model_dir, filename)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
