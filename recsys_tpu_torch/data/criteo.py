"""Criteo data plane: feature transforms, the offline TSV preprocessor and
the synthetic generator.

A NumPy-only copy of ``recsys_tpu/data/criteo.py`` (same arrays for the
same seed or the same TSV, pinned by tests/test_torch_data.py and
tests/test_torch_pipeline.py). Each example is

    ids:   int32  [N, 39]  field-local ids (13 bucketized cont + 26 hashed cat)
    dense: float32 [N, 13] log-scaled continuous values
    label: float32 [N]

`preprocess_tsv` turns a raw Criteo TSV (label, 13 integers, 26 hex
strings, tab-separated; empty fields missing) into ``part-r-NNNNN.npz``
shards: missing continuous values take the column mean, categorical
values are hashed ('NULL' when missing). It parses with the native host
library (`native`) when it is built, else in pure Python; both give the
same arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.data import hashing, native
from recsys_tpu_torch.train.metrics import roc_auc


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
# TSV parsing (the pure-Python path; native/criteo_parser.cc is the fast
# path, used when the host library is built)
# ---------------------------------------------------------------------------

def parse_tsv_chunk(lines: list[str]
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Criteo TSV lines (label \\t 13 ints \\t 26 hex strings) → (labels,
    cont with NaN for missing, cat object array with '' for missing)."""
    n = len(lines)
    labels = np.empty(n, np.float32)
    cont = np.full((n, 13), np.nan, np.float32)
    cat = np.empty((n, 26), object)
    for i, line in enumerate(lines):
        parts = line.rstrip("\n").split("\t")
        labels[i] = float(parts[0])
        for j in range(13):
            v = parts[1 + j] if 1 + j < len(parts) else ""
            cont[i, j] = float(v) if v != "" else np.nan
        for j in range(26):
            v = parts[14 + j] if 14 + j < len(parts) else ""
            cat[i, j] = v
    return labels, cont, cat


def compute_means(tsv_path: str, max_rows: int | None = None) -> np.ndarray:
    """Pass 1: the mean of each continuous column over its present values
    in the first ``max_rows`` lines (all by default; the reference ETL's
    mean imputation)."""
    sums = np.zeros(13, np.float64)
    counts = np.zeros(13, np.int64)
    with open(tsv_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            parts = line.rstrip("\n").split("\t")
            for j in range(13):
                v = parts[1 + j] if 1 + j < len(parts) else ""
                if v != "":
                    sums[j] += float(v)
                    counts[j] += 1
    return (sums / np.maximum(counts, 1)).astype(np.float32)


def _parse(lines: list[str], cfg: CriteoConfig):
    """(labels, cont with NaN for missing, hashed cat ids) of TSV lines:
    the native parser when the host library is built, else Python."""
    if native.available():
        labels, cont, cat_ids, _ = native.parse_criteo_bytes(
            "".join(lines).encode(), cfg.cat_vocabs)
        return labels, cont, cat_ids
    labels, cont, cat = parse_tsv_chunk(lines)
    return labels, cont, hash_cat(cat, cfg)


def preprocess_tsv(tsv_path: str, out_dir: str,
                   cfg: CriteoConfig = CriteoConfig(),
                   rows_per_shard: int = 200_000,
                   max_rows: int | None = None,
                   means: np.ndarray | None = None,
                   bucketize_log: bool = False) -> list[str]:
    """The first ``max_rows`` lines of a TSV (all by default) →
    ``part-r-NNNNN.npz`` shards of ``rows_per_shard`` rows (the last one
    shorter) and ``cont_means.npy`` in ``out_dir``; → the shard paths.
    ``means`` impute the missing continuous values (an eval set takes the
    training set's); by default a first pass over the same lines
    (`compute_means`) gives them."""
    os.makedirs(out_dir, exist_ok=True)
    if means is None:
        means = compute_means(tsv_path, max_rows)
    np.save(os.path.join(out_dir, "cont_means.npy"), means)
    shard_paths: list[str] = []

    def flush(lines: list[str]) -> None:
        labels, cont, cat_ids = _parse(lines, cfg)
        cont = np.where(np.isnan(cont), means[None, :], cont)
        ids = np.concatenate([bucketize_cont(cont, cfg, bucketize_log),
                              cat_ids], axis=1)
        path = os.path.join(out_dir, f"part-r-{len(shard_paths):05d}.npz")
        np.savez(path, ids=ids, dense=log_transform(cont, cfg), label=labels)
        shard_paths.append(path)

    buf: list[str] = []
    with open(tsv_path) as f:
        for i, line in enumerate(f):
            if max_rows is not None and i >= max_rows:
                break
            buf.append(line)
            if len(buf) >= rows_per_shard:
                flush(buf)
                buf = []
    if buf:
        flush(buf)
    return shard_paths


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


def synthetic_bayes_metrics(
    num_rows: int,
    cfg: CriteoConfig = CriteoConfig(),
    spec: SyntheticSpec = SyntheticSpec(),
    start_row: int = 0,
) -> dict[str, float]:
    """AUC and logloss of the TRUE planted probabilities on a slice: the
    Bayes ceiling no model can beat in expectation, reported beside
    trained metrics (the AUC exact, `metrics.roc_auc`)."""
    d = synthetic_criteo(num_rows, cfg, spec, start_row, _return_prob=True)
    p = np.clip(d["_true_prob"], 1e-12, 1 - 1e-12)
    y = d["label"]
    return {
        "auc": roc_auc(y, p),
        "logloss": float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p))),
    }


_HEX = np.frombuffer(b"0123456789abcdef", dtype="S1")


def write_synthetic_tsv(path: str, rows: int, seed: int = 0) -> None:
    """A raw Criteo-format TSV of ``rows`` random lines: a 0/1 label, 13
    integers in [0, 1000) with about 20% missing, 26 8-digit hex strings
    with about 10% missing (the preprocessor's input, made from ``seed``;
    the raw Criteo set is not in the repository)."""
    rng = np.random.default_rng(seed)
    chunk = 65_536
    with open(path, "w") as f:
        for lo in range(0, rows, chunk):
            n = min(chunk, rows - lo)
            label = rng.integers(0, 2, n)
            cont = rng.integers(0, 1000, (n, 13))
            cont_miss = rng.random((n, 13)) < 0.2
            cats = rng.integers(0, 1 << 32, (n, 26), dtype=np.uint64)
            cat_miss = rng.random((n, 26)) < 0.1
            nibbles = np.stack([(cats >> np.uint64(28 - 4 * k)) & 15
                                for k in range(8)], axis=-1)
            hexes = _HEX[nibbles].view("S8")[..., 0].astype("U8")
            cols = [label.astype(str).tolist()]
            cols += [np.where(cont_miss[:, j], "",
                              cont[:, j].astype(str)).tolist()
                     for j in range(13)]
            cols += [np.where(cat_miss[:, j], "", hexes[:, j]).tolist()
                     for j in range(26)]
            f.writelines("\t".join(r) + "\n" for r in zip(*cols))


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
