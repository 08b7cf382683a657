"""The classical models in the port against the JAX package's, on the same
inputs (host code in both; the CSVs made as ``tests/test_classical.py``
makes them):

- FTRL-proximal: ``z``, ``n`` and the held-out loss bitwise after
  ``train_csv`` (with and without poly2 interactions), the submission file
  byte for byte;
- GBDT+LR and the leaf-feature comparison: equal results;
- ``tools/gbdt_fe``: the JSON equal to the JAX command's, on synthetic
  data and on a CSV (read with ``csv`` and numpy against the JAX
  command's pandas).
"""

import numpy as np
import pytest

from recsys_tpu.models import ftrl_lr as JF
from recsys_tpu.models import gbdt_lr as JG
from recsys_tpu.tools import gbdt_fe as jfe
from recsys_tpu_torch.models import ftrl_lr as F
from recsys_tpu_torch.models import gbdt_lr as G
from recsys_tpu_torch.tools import gbdt_fe
from test_classical import (_avazu_like_csv, _forest_like,
                            _forest_multiclass)


@pytest.mark.parametrize("interaction,holdafter,epochs", [
    (False, 8, 2), (True, 8, 1), (False, None, 1)])
def test_ftrl_train_csv_is_bitwise_jax(tmp_path, interaction, holdafter,
                                       epochs):
    path = str(tmp_path / "train.csv")
    _avazu_like_csv(path, n=400)
    kw = dict(epochs=epochs, holdafter=holdafter, D=2 ** 14, alpha=0.3,
              interaction=interaction)
    got, got_loss = F.train_csv(path, **kw)
    want, want_loss = JF.train_csv(path, **kw)
    np.testing.assert_array_equal(got.z, want.z)
    np.testing.assert_array_equal(got.n, want.n)
    assert np.isnan(got_loss) if holdafter is None else \
        got_loss == want_loss
    assert np.abs(got.z).max() > 0


def test_ftrl_submission_is_byte_for_byte_jax(tmp_path):
    train = str(tmp_path / "train.csv")
    _avazu_like_csv(train, n=150)
    got, _ = F.train_csv(train, holdafter=None, D=2 ** 14)
    want, _ = JF.train_csv(train, holdafter=None, D=2 ** 14)
    F.write_submission(got, train, str(tmp_path / "got.csv"))
    JF.write_submission(want, train, str(tmp_path / "want.csv"))
    got_bytes = (tmp_path / "got.csv").read_bytes()
    assert got_bytes == (tmp_path / "want.csv").read_bytes()
    assert got_bytes.count(b"\n") == 151


def test_gbdt_lr_pipeline_matches_jax():
    x, y = _forest_like()
    got = G.gbdt_lr_pipeline(x[:600], y[:600], x[600:], y[600:],
                             n_trees=20, num_leaves=8)
    want = JG.gbdt_lr_pipeline(x[:600], y[:600], x[600:], y[600:],
                               n_trees=20, num_leaves=8)
    assert (got["nce"], got["C"], got["leaf_width"]) == \
        (want["nce"], want["C"], want["leaf_width"])
    leaves = G.leaf_indices(got["gbdt"], x)
    np.testing.assert_array_equal(leaves, JG.leaf_indices(want["gbdt"], x))
    np.testing.assert_array_equal(G.leaf_one_hot(leaves, got["leaf_width"]),
                                  JG.leaf_one_hot(leaves,
                                                  want["leaf_width"]))
    np.testing.assert_array_equal(G.merged_features(x, leaves),
                                  JG.merged_features(x, leaves))
    assert got["nce"] < 1.0


def test_leaf_feature_comparison_matches_jax():
    x, y = _forest_multiclass()
    kw = dict(stage1_trees=5, stage2_trees=15, num_leaves=8)
    got = G.leaf_feature_comparison(x, y, **kw)
    assert got == JG.leaf_feature_comparison(x, y, **kw)
    assert got["acc_raw"] > 1.0 / 3 + 0.1


ARGS = ["--n_trees=10", "--num_leaves=8", "--stage1_trees=4",
        "--stage2_trees=8"]


def test_gbdt_fe_synthetic_matches_jax(capsys):
    got = gbdt_fe.main(ARGS + ["--synthetic_rows=600"])
    assert got == jfe.main(ARGS + ["--synthetic_rows=600"])
    assert got["gbdt_lr"]["nce"] < 1.0


def test_gbdt_fe_csv_matches_jax_pandas_read(tmp_path, capsys):
    """A Forest-Cover-like CSV (an Id column, integer and decimal
    features, the class last): the port's csv + numpy read gives the
    arrays the JAX command's pandas read gives, and the same JSON."""
    x, y = gbdt_fe._synthetic_forest(n=500, seed=4)
    path = tmp_path / "train.csv"
    with open(path, "w") as f:
        f.write("Id," + ",".join(f"f{j}" for j in range(x.shape[1]))
                + ",Elevation,Cover_Type\n")
        for i in range(len(y)):
            f.write(f"{i + 1}," + ",".join(f"{v:.5f}" for v in x[i])
                    + f",{2000 + 7 * i},{y[i] + 1}\n")
    got_x, got_y = gbdt_fe.read_csv(str(path), "Cover_Type")
    import pandas as pd
    df = pd.read_csv(path)
    del df["Id"]
    want_y = df["Cover_Type"].to_numpy()
    want_x = df.drop("Cover_Type", axis=1).to_numpy(np.float32)
    assert got_y.dtype == want_y.dtype
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_x, want_x)
    argv = ARGS + [f"--csv={path}"]
    assert gbdt_fe.main(argv) == jfe.main(argv)
