"""Criteo data plane: feature transforms + the synthetic generator.

A NumPy-only copy of ``recsys_tpu/data/criteo.py`` (same arrays for the
same seed, pinned by tests/test_torch_data.py). Each example is

    ids:   int32  [N, 39]  field-local ids (13 bucketized cont + 26 hashed cat)
    dense: float32 [N, 13] log-scaled continuous values
    label: float32 [N]

The offline TSV preprocessor (``preprocess_tsv`` and the native parser
behind it) belongs to the input pipeline and is not ported yet; serving
and the in-device training path need the schema, the synthetic generator
and its ``.npz`` shards.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.data import hashing


# ---------------------------------------------------------------------------
# Transform core
# ---------------------------------------------------------------------------

def log_transform(values: np.ndarray, cfg: CriteoConfig) -> np.ndarray:
    """[N, 13] imputed raw → log-scaled. _c2 (index 1) uses shift 4."""
    shifts = np.full((values.shape[1],), cfg.log_shift_default, np.float32)
    shifts[1] = cfg.log_shift_c2
    return np.log(np.maximum(values, 0.0) + shifts).astype(np.float32)


def bucketize_cont(
    values: np.ndarray, cfg: CriteoConfig, bucketize_log: bool = False
) -> np.ndarray:
    """[N, 13] imputed raw → int32 bucket ids via the reference boundaries."""
    src = log_transform(values, cfg) if bucketize_log else values
    out = np.empty(src.shape, np.int32)
    for j, bounds in enumerate(cfg.cont_boundaries):
        out[:, j] = np.searchsorted(np.asarray(bounds), src[:, j], side="right")
    return out


def hash_cat(raw_cat: np.ndarray, cfg: CriteoConfig) -> np.ndarray:
    """[N, 26] object array of strings ('' = missing) → int32 hashed ids."""
    n = raw_cat.shape[0]
    out = np.empty((n, 26), np.int32)
    for j, vocab in enumerate(cfg.cat_vocabs):
        col = raw_cat[:, j]
        col = np.where(col == "", cfg.null_token, col)
        out[:, j] = hashing.hash_bucket_array(col, vocab)
    return out


# ---------------------------------------------------------------------------
# Synthetic Criteo (planted logistic ground truth)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SyntheticSpec:
    """Planted model:

        logit = bias + Σ_f effect_f[id_f]                      (first order)
              + Σ_{f<g} <U_f[id_f], U_g[id_g]>                 (second order)
              + w·dense                                        (linear dense)

    The second-order term is a planted rank-``interaction_rank`` latent per
    (field, id): U_f[i] ~ N(0, interaction_scale² I) — the FM generative
    model over all field pairs.
    """

    seed: int = 0
    effect_scale: float = 0.35
    dense_scale: float = 0.15
    bias: float = -1.2   # skewed label rate like Criteo (~25% positive)
    interaction_rank: int = 4
    interaction_scale: float = 0.14


def synthetic_criteo(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
    _return_prob: bool = False,
) -> dict[str, np.ndarray]:
    """Deterministic synthetic batch with learnable structure.

    Ids follow a zipf-like skew (realistic hot rows); labels come from a
    planted sparse-logistic model so trained AUC has a meaningful ceiling.
    ``start_row`` makes disjoint, reproducible slices for sharded loaders.
    """
    field_vocabs = cfg.field_vocab_sizes
    row_rng = np.random.default_rng([spec.seed, start_row])

    k = spec.interaction_rank
    ids = np.empty((num_rows, len(field_vocabs)), np.int32)
    logit = np.full(num_rows, spec.bias, np.float64)
    lat_sum = np.zeros((num_rows, k), np.float64)   # s = Σ_f U_f[id_f]
    lat_sq = np.zeros(num_rows, np.float64)         # Σ_f ||U_f[id_f]||²
    for f, vocab in enumerate(field_vocabs):
        # zipf-ish: draw from a power-law over the vocab
        u = row_rng.random(num_rows)
        raw = np.floor(vocab * u ** 2.2).astype(np.int64) % vocab
        ids[:, f] = raw
        eff_rng = np.random.default_rng([spec.seed, 31 * f + 1])
        effects = eff_rng.normal(0.0, spec.effect_scale, vocab)
        logit += effects[raw]
        if k and spec.interaction_scale:
            lat_rng = np.random.default_rng([spec.seed, 31 * f + 2])
            lat = lat_rng.normal(0.0, spec.interaction_scale, (vocab, k))
            rows = lat[raw]
            lat_sum += rows
            lat_sq += np.einsum("nk,nk->n", rows, rows)
    if k and spec.interaction_scale:
        # Σ_{f<g} <u_f, u_g> via the FM identity ½(||Σu||² − Σ||u||²)
        logit += 0.5 * (np.einsum("nk,nk->n", lat_sum, lat_sum) - lat_sq)

    # dense feature count follows the schema (13 for Criteo)
    n_cont = len(cfg.cont_boundaries)
    dense = row_rng.lognormal(0.0, 1.0, (num_rows, n_cont)).astype(np.float32)
    wd_rng = np.random.default_rng([spec.seed, 999])
    w_dense = wd_rng.normal(0.0, spec.dense_scale, n_cont)
    logit += np.log1p(dense) @ w_dense

    prob = 1.0 / (1.0 + np.exp(-logit))
    label = (row_rng.random(num_rows) < prob).astype(np.float32)
    out = {
        "ids": ids,
        "dense": np.log1p(dense).astype(np.float32),
        "label": label,
    }
    if _return_prob:
        out["_true_prob"] = prob
    return out


def write_synthetic_shards(out_dir: str, num_rows: int, num_shards: int,
                           cfg: CriteoConfig = CriteoConfig(),
                           spec: SyntheticSpec = SyntheticSpec()) -> list[str]:
    """``num_shards`` files ``part-r-NNNNN.npz`` of ``num_rows //
    num_shards`` disjoint synthetic rows each (the JAX package's shards)."""
    os.makedirs(out_dir, exist_ok=True)
    rows_per = num_rows // num_shards
    paths = []
    for s in range(num_shards):
        data = synthetic_criteo(rows_per, cfg, spec, start_row=s * rows_per)
        path = os.path.join(out_dir, f"part-r-{s:05d}.npz")
        np.savez(path, **data)
        paths.append(path)
    return paths
