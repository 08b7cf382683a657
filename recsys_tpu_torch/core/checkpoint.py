"""Checkpoints in the JAX package's on-disk format, without jax
(counterpart of ``recsys_tpu/core/checkpoint.py``).

A checkpoint is a directory ``step_N/`` holding

- ``arrays.npz``: one array per leaf, named ``leaf_0``, ``leaf_1``, ...;
- ``meta.json``: ``{"step", "metric", "manifest", "extra"}``, where
  ``manifest`` lists ``[path, leaf key]`` pairs and ``path`` is the leaf's
  jax key string, e.g. ``[0]['cin'][0]['w']``.

The JAX package's ``restore`` matches leaves to its template BY POSITION,
so `flatten` emits them in jax's flatten order: dict keys sorted, lists and
tuples in index order. Like jax, it drops empty containers, which hold no
leaves. `restore` rebuilds the tree from the paths alone: ``['key']``
becomes a dict entry, ``[i]`` a list entry.
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil

import numpy as np

_PATH_ITEM = re.compile(r"\[(\d+|'(?:[^'\\]|\\.)*')\]")


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(jax key string, leaf)] in jax's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], f"{prefix}[{k!r}]")
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


def fill_like(template, leaves):
    """``template``'s structure (empty containers included) with its leaves
    replaced, in flatten order, by ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    out = walk(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


class CheckpointManager:
    """Step-indexed checkpoints with keep-last-k retention."""

    def __init__(self, directory: str, keep_max: int = 5):
        self.directory = directory
        self.keep_max = keep_max
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def save(self, step: int, tree) -> str:
        """Write ``tree`` (leaves: numpy arrays) as ``step_<step>``.

        Crash-atomic: written under ``step_N.tmp`` and published with one
        rename, so a reader never sees a partial checkpoint."""
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
            json.dump({"step": step, "metric": None, "manifest": manifest,
                       "extra": {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        dirs = self._step_dirs()
        for _, old in dirs[: max(0, len(dirs) - self.keep_max)]:
            shutil.rmtree(old)
        return path

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def restore(self):
        """(tree of numpy arrays, step) of the latest checkpoint, or None
        when there is none. The tree is rebuilt from the manifest's paths."""
        step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            pairs = [(p, z[key]) for p, key in meta["manifest"]]
        return unflatten(pairs), meta["step"]
