"""GBDT feature-engineering command line (counterpart of
``recsys_tpu/tools/gbdt_fe.py``): both reference pipelines
(gbdt_feature_engineering/gbdt_lr.py and main.py) on a CSV or on a
synthetic stand-in for Forest Cover, on the host (scikit-learn).

    python -m recsys_tpu_torch.tools.gbdt_fe \
        [--csv=/path/to/train.csv --target=Cover_Type [--drop=Id]] \
        [--n_trees=100] [--num_leaves=63] \
        [--stage1_trees=10] [--stage2_trees=40] [--synthetic_rows=2000]

Prints one JSON line (the JAX command's):
- "gbdt_lr": the leaf-one-hot → LogisticRegression-over-a-C-grid
  pipeline's best NCE and C (gbdt_lr.py:59-128);
- "comparison": the raw against raw+leaf second-stage accuracy
  (main.py:20-118).

The CSV is read with ``csv`` and numpy (no pandas): a header line, then
numeric columns; the target's column is int64 where every value is an
integer, else float64, and the features float32, as the JAX command's
pandas read gives them.
"""

from __future__ import annotations

import csv
import json
import logging
import sys

import numpy as np

from recsys_tpu_torch.models import gbdt_lr as G


def _synthetic_forest(n=2000, n_classes=4, seed=0):
    """A planted multi-class task standing in for Forest Cover's
    train.csv (the JAX command's)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = rng.normal(size=(12, n_classes))
    logits = x @ w + 0.5 * (x[:, :1] * x[:, 1:2]) @ rng.normal(
        size=(1, n_classes))
    y = np.argmax(logits + rng.gumbel(0, 0.5, logits.shape), axis=1)
    return x, y.astype(np.int64)


def read_csv(path: str, target: str, drop: tuple[str, ...] = ("Id",)
             ) -> tuple[np.ndarray, np.ndarray]:
    """(features [N, C] float32, target [N]) of a numeric CSV with a
    header; the columns in ``drop`` that it has are left out."""
    with open(path, newline="") as f:
        rows = csv.reader(f)
        header = next(rows)
        cells = np.array([r for r in rows], dtype=object).reshape(
            -1, len(header))
    cols = {name: j for j, name in enumerate(header)}
    t = cells[:, cols[target]].astype(str)
    try:
        y = t.astype(np.int64)
    except ValueError:
        y = t.astype(np.float64)
    keep = [j for name, j in cols.items()
            if name != target and name not in drop]
    x = cells[:, keep].astype(str).astype(np.float64).astype(np.float32)
    return x, y


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)

    if "csv" in kv:
        x, y = read_csv(kv["csv"], kv.get("target", "Cover_Type"),
                        tuple(kv.get("drop", "Id").split(",")))
    else:
        x, y = _synthetic_forest(
            n=int(kv.get("synthetic_rows", 2000)),
            seed=int(kv.get("seed", 0)))

    # shuffle before the train/validation split (main.py:23 data.sample):
    # Forest Cover's train.csv is grouped by Cover_Type
    rng = np.random.default_rng(int(kv.get("seed", 0)))
    order = rng.permutation(len(y))
    x, y = x[order], y[order]
    n_val = max(1, len(y) // 5)
    binary_y = (y == np.unique(y)[0]).astype(np.int64)  # the LR is binary
    gbdt_lr = G.gbdt_lr_pipeline(
        x[n_val:], binary_y[n_val:], x[:n_val], binary_y[:n_val],
        n_trees=int(kv.get("n_trees", 100)),
        num_leaves=int(kv.get("num_leaves", 63)),
    )
    comparison = G.leaf_feature_comparison(
        x, y,
        stage1_trees=int(kv.get("stage1_trees", 10)),
        stage2_trees=int(kv.get("stage2_trees", 40)),
        num_leaves=int(kv.get("num_leaves", 63)),
        seed=int(kv.get("seed", 0)),
    )
    result = {
        "gbdt_lr": {"nce": gbdt_lr["nce"], "C": gbdt_lr["C"],
                    "leaf_width": gbdt_lr["leaf_width"]},
        "comparison": comparison,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
