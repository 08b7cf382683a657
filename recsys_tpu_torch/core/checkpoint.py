"""Checkpoints in the JAX package's on-disk format, without jax
(counterpart of ``recsys_tpu/core/checkpoint.py``).

A checkpoint is a directory ``step_N/`` holding

- ``arrays.npz``: one array per leaf, named ``leaf_0``, ``leaf_1``, ...;
- ``meta.json``: ``{"step", "metric", "manifest", "extra"}``, where
  ``manifest`` lists ``[path, leaf key]`` pairs and ``path`` is the leaf's
  jax key string, e.g. ``[0]['cin'][0]['w']``.

``best/`` is a copy of the step whose ``metric`` was the highest, in the
same format, so each package restores the other's ``best/``.

The JAX package's ``restore`` matches leaves to its template BY POSITION,
so `flatten` emits them in jax's flatten order: dict keys sorted, lists and
tuples in index order. Like jax, it drops empty containers, which hold no
leaves; a NamedTuple's fields are written ``.name``, as jax writes them.
`CheckpointManager.restore` rebuilds a tree of dicts and lists from the
paths alone (``['key']`` becomes a dict entry, ``[i]`` a list entry), or,
given a template, puts the leaves into the template's structure by
position, as the JAX package does, and checks paths and shapes: the only
way back to a NamedTuple such as the optimizer state.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil

import numpy as np

from recsys_tpu_torch.core import tree as tree_util

_PATH_ITEM = re.compile(r"\[(\d+|'(?:[^'\\]|\\.)*')\]")


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(jax key string, leaf)] in jax's flatten order; a NamedTuple's
    fields are ``.name``, as jax writes them (``[2].mu['tables']``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if tree_util.is_namedtuple(tree):
        out = []
        for name, v in zip(tree._fields, tree):
            out += flatten(v, f"{prefix}.{name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def parse_path(path: str) -> list[int | str]:
    """``"[0]['cin'][0]['w']"`` → ``[0, 'cin', 0, 'w']``."""
    keys: list[int | str] = []
    pos = 0
    for m in _PATH_ITEM.finditer(path):
        if m.start() != pos:
            break
        tok = m.group(1)
        keys.append(int(tok) if tok.isdigit() else ast.literal_eval(tok))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"unsupported checkpoint path {path!r}")
    return keys


def unflatten(pairs) -> list | dict:
    """Nested dicts/lists from [(path, leaf)] (the inverse of `flatten`,
    up to empty containers and tuple-vs-list)."""
    root: dict = {}
    for path, leaf in pairs:
        keys = parse_path(path)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise ValueError(f"duplicate checkpoint path {path!r}")
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"list indices {sorted(node)} have gaps")
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


class CheckpointManager:
    """Step-indexed checkpoints with keep-last-k and keep-best retention.

    ``save(..., metric=)`` copies the step to ``best/`` whenever the metric
    improves (higher is better), as the JAX package does; the best metric
    is read back from ``best/meta.json`` when a manager opens a directory,
    and retention never deletes ``best/``."""

    def __init__(self, directory: str, keep_max: int = 5):
        self.directory = directory
        self.keep_max = keep_max
        os.makedirs(directory, exist_ok=True)
        self._best_metric: float | None = None
        best_meta = os.path.join(directory, "best", "meta.json")
        if os.path.exists(best_meta):
            with open(best_meta) as f:
                self._best_metric = json.load(f).get("metric")

    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def save(self, step: int, tree, metric: float | None = None,
             extra: dict | None = None) -> str:
        """Write ``tree`` (leaves: numpy arrays) as ``step_<step>``, with
        ``metric`` (e.g. the eval AUC) and ``extra`` in its meta; refresh
        ``best/`` when ``metric`` beats the best so far.

        Crash-atomic: each directory is written under a ``.tmp`` name and
        published with one rename, so a reader never sees a partial
        checkpoint."""
        path = os.path.join(self.directory, f"step_{step}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays, manifest = {}, []
        for i, (p, leaf) in enumerate(flatten(tree)):
            arrays[f"leaf_{i}"] = np.asarray(leaf)
            manifest.append((p, f"leaf_{i}"))
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "metric": metric, "manifest": manifest,
                       "extra": extra or {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        if metric is not None and (self._best_metric is None
                                   or metric > self._best_metric):
            self._best_metric = metric
            best = os.path.join(self.directory, "best")
            if os.path.exists(best + ".tmp"):
                shutil.rmtree(best + ".tmp")
            shutil.copytree(path, best + ".tmp")
            if os.path.exists(best):
                shutil.rmtree(best)
            os.rename(best + ".tmp", best)
        dirs = self._step_dirs()
        for _, old in dirs[: max(0, len(dirs) - self.keep_max)]:
            shutil.rmtree(old)
        return path

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def restore(self, template=None, step: int | None = None,
                best: bool = False):
        """(tree of numpy arrays, step, extra) of ``best/`` (``best=True``),
        of ``step_<step>``, or of the latest checkpoint; None when there is
        none. Without a template the tree is rebuilt from the manifest's
        paths; with one, the leaves fill the template's structure in order,
        and a path or shape that differs from the template's raises."""
        if best:
            path = os.path.join(self.directory, "best")
        else:
            step = self.latest_step() if step is None else step
            if step is None:
                return None
            path = os.path.join(self.directory, f"step_{step}")
        if not os.path.exists(path):
            return None
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            pairs = [(p, z[key]) for p, key in meta["manifest"]]
        extra = meta.get("extra", {})
        if template is None:
            return unflatten(pairs), meta["step"], extra
        want = flatten(template)
        if len(want) != len(pairs):
            raise ValueError(f"checkpoint has {len(pairs)} leaves, template "
                             f"has {len(want)}")
        for (p, leaf), (wp, wleaf) in zip(pairs, want):
            if p != wp or tuple(np.shape(leaf)) != tuple(wleaf.shape):
                raise ValueError(f"checkpoint leaf {p} {np.shape(leaf)} does "
                                 f"not match template {wp} "
                                 f"{tuple(wleaf.shape)}")
        return (tree_util.fill_like(template, [a for _, a in pairs]),
                meta["step"], extra)
