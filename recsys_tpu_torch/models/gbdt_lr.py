"""GBDT leaf-index featurization + LR (counterpart of
``recsys_tpu/models/gbdt_lr.py``; the reference's gbdt_feature_engineering/).

Host code, as in the JAX package, on scikit-learn:

- ``gbdt_lr.py:52-128``: train a GBDT, extract per-tree leaf indices for
  every example (``pred_leaf=True``; scikit-learn's ``.apply()``), one-hot
  encode the [n_trees × n_leaves] leaf matrix, fit LogisticRegression over
  a C grid, score with the normalized cross-entropy;
- ``main.py:33-118``: leaf features appended to the raw features and fed to
  a second model for an accuracy comparison.

The backing library is scikit-learn's GradientBoostingClassifier (xgboost
and lightgbm are not used). Where scikit-learn does not import, importing
this module raises an ImportError that names it.
"""

from __future__ import annotations

import numpy as np

try:
    from sklearn.ensemble import GradientBoostingClassifier
    from sklearn.linear_model import LogisticRegression
except ImportError as e:
    raise ImportError(
        "recsys_tpu_torch.models.gbdt_lr needs scikit-learn (the sklearn "
        f"package), which does not import here: {e}") from e

from recsys_tpu_torch.train.metrics import normalized_cross_entropy


def train_gbdt(
    x: np.ndarray, y: np.ndarray,
    *, n_trees: int = 100, num_leaves: int = 63, learning_rate: float = 0.01,
    seed: int = 0,
) -> GradientBoostingClassifier:
    """Reference config: 200 trees × 63 leaves, lr .01 (gbdt_lr.py:33-45);
    sklearn expresses leaf cap via max_leaf_nodes."""
    clf = GradientBoostingClassifier(
        n_estimators=n_trees, max_leaf_nodes=num_leaves,
        learning_rate=learning_rate, random_state=seed,
    )
    clf.fit(x, y)
    return clf


def leaf_indices(clf: GradientBoostingClassifier, x: np.ndarray) -> np.ndarray:
    """[N, n_trees·n_class_stages] leaf ids (the ``pred_leaf=True`` /
    ``clf.apply`` matrix, gbdt_lr.py:65, main.py:53)."""
    # sklearn returns [N, n_trees, n_classes_per_stage]; binary has one
    # stage per tree, multiclass K — flatten every stage into a feature
    leaves = clf.apply(x)
    if leaves.ndim == 3:
        leaves = leaves.reshape(leaves.shape[0], -1)
    return leaves.astype(np.int64)


def leaf_one_hot(leaves: np.ndarray,
                 num_leaves: int | None = None) -> np.ndarray:
    """One-hot per tree, concatenated (gbdt_lr.py:62-75)."""
    n, n_trees = leaves.shape
    if num_leaves is None:
        num_leaves = int(leaves.max()) + 1
    out = np.zeros((n, n_trees * num_leaves), np.float32)
    cols = (np.arange(n_trees) * num_leaves)[None, :] + leaves
    out[np.arange(n)[:, None], cols] = 1.0
    return out


def fit_lr_grid(
    train_feats: np.ndarray, train_y: np.ndarray,
    val_feats: np.ndarray, val_y: np.ndarray,
    c_grid: tuple[float, ...] = (0.05, 0.1, 0.5, 1.0),
) -> tuple[LogisticRegression, float, float]:
    """LR over a C grid, pick best val NCE (gbdt_lr.py:106-127)."""
    best = (None, np.inf, np.nan)
    for c in c_grid:
        lr = LogisticRegression(C=c, max_iter=500)
        lr.fit(train_feats, train_y)
        prob = lr.predict_proba(val_feats)[:, 1]
        nce = normalized_cross_entropy(val_y, prob)
        if nce < best[1]:
            best = (lr, nce, c)
    return best


def gbdt_lr_pipeline(
    x_train, y_train, x_val, y_val,
    *, n_trees: int = 100, num_leaves: int = 63,
) -> dict:
    """End-to-end gbdt_lr.py pipeline → {'nce', 'C', 'model', 'gbdt'}."""
    gbdt = train_gbdt(x_train, y_train, n_trees=n_trees,
                      num_leaves=num_leaves)
    # normalize leaf ids to dense per-tree range for one-hot width
    tr_leaves = leaf_indices(gbdt, x_train)
    va_leaves = leaf_indices(gbdt, x_val)
    width = int(max(tr_leaves.max(), va_leaves.max())) + 1
    lr, nce, c = fit_lr_grid(
        leaf_one_hot(tr_leaves, width), y_train,
        leaf_one_hot(va_leaves, width), y_val,
    )
    return {"nce": nce, "C": c, "model": lr, "gbdt": gbdt,
            "leaf_width": width}


def merged_features(x: np.ndarray, leaves: np.ndarray) -> np.ndarray:
    """Raw + leaf-index features side by side (main.py:12-18 mergeToOne)."""
    return np.concatenate([x, leaves.astype(x.dtype)], axis=1)


def leaf_feature_comparison(
    x: np.ndarray, y: np.ndarray,
    *, stage1_trees: int = 10, stage2_trees: int = 40, num_leaves: int = 31,
    test_size: float = 0.1, stage2_frac: float = 0.6, seed: int = 0,
) -> dict:
    """The main.py:20-118 experiment: does appending stage-1 leaf-index
    features improve a second-stage model?

    Protocol (multi-class, Forest-Cover style): hold out ``test_size`` for
    the final comparison (main.py:29); split the rest into a stage-1 set
    (trains the feature-generating GBDT, main.py:32-50) and a stage-2 set
    (main.py:32, test_size=0.6). Train the second-stage model twice — on raw
    stage-2 features (main.py:89-95) and on raw+leaf merged features
    (main.py:109-118) — and report test accuracy for both.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))            # main.py:23 data.sample
    x, y = x[order], y[order]
    n_test = max(1, int(test_size * len(y)))
    x_test, y_test = x[:n_test], y[:n_test]
    x_tr, y_tr = x[n_test:], y[n_test:]
    n2 = int(stage2_frac * len(y_tr))
    x1, y1 = x_tr[n2:], y_tr[n2:]              # stage-1 (feature generator)
    x2, y2 = x_tr[:n2], y_tr[:n2]              # stage-2 (second model)

    stage1 = GradientBoostingClassifier(
        n_estimators=stage1_trees, max_leaf_nodes=num_leaves,
        learning_rate=0.2, random_state=seed)  # main.py:34-47 lr=0.2
    stage1.fit(x1, y1)
    acc_stage1 = float(np.mean(stage1.predict(x1) == y1))  # main.py:54-58

    leaves_2 = leaf_indices(stage1, x2)        # main.py:53 clf.apply
    leaves_te = leaf_indices(stage1, x_test)   # main.py:74

    def second(xt, xe):                        # main.py:78-95 / 97-118
        m = GradientBoostingClassifier(
            n_estimators=stage2_trees, max_leaf_nodes=num_leaves,
            learning_rate=0.05, random_state=seed + 1)
        m.fit(xt, y2)
        return float(np.mean(m.predict(xe) == y_test))

    acc_raw = second(x2, x_test)
    acc_merged = second(merged_features(x2, leaves_2),
                        merged_features(x_test, leaves_te))
    return {
        "acc_stage1_train": acc_stage1,
        "acc_raw": acc_raw,
        "acc_raw_plus_leaf": acc_merged,
        "leaf_gain": acc_merged - acc_raw,
        "n_leaf_features": int(leaves_2.shape[1]),
    }
