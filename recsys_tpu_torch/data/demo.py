"""The DeepFM demo schema: two hashed integer id features, u_id and i_id
(counterpart of ``recsys_tpu/data/demo.py``; the same arrays for the same
seed).

The reference's DeepFM experiments run on a two-column dataset, a user id
hashed into 500,000 buckets and an item id into 100,000, not on Criteo.
Here that schema is a `CriteoConfig` with no continuous fields and two
hashed categorical vocabs, so the whole CTR zoo, generic over
``field_vocab_sizes``, runs on it unchanged. Raw int64 ids are hashed on
the host with the splitmix64 bucket hash of `hashing.hash_int_bucket`.
"""

from __future__ import annotations

import numpy as np

from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.data import hashing


def demo_schema(u_buckets: int = 500_000,
                i_buckets: int = 100_000) -> CriteoConfig:
    """Feature statics of the u_id/i_id demo dataset."""
    return CriteoConfig(cont_boundaries=(), cat_vocabs=(u_buckets, i_buckets))


def hash_demo_batch(u_ids: np.ndarray, i_ids: np.ndarray,
                    labels: np.ndarray | None,
                    schema: CriteoConfig) -> dict:
    """Raw int64 (u_id, i_id) → model batch {'ids' [B, 2], 'dense' [B, 0],
    'label'}."""
    u_b, i_b = schema.cat_vocabs
    ids = np.stack([
        hashing.hash_int_bucket(np.asarray(u_ids), u_b),
        hashing.hash_int_bucket(np.asarray(i_ids), i_b),
    ], axis=1)
    batch = {
        "ids": ids.astype(np.int32),
        "dense": np.zeros((len(ids), 0), np.float32),
    }
    if labels is not None:
        batch["label"] = np.asarray(labels, np.float32)
    return batch


def synthetic_demo(n_rows: int, *, n_users: int = 5000, n_items: int = 1000,
                   rank: int = 8, seed: int = 0,
                   schema: CriteoConfig | None = None) -> dict:
    """A planted low-rank user × item CTR task: raw ids and labels → a
    hashed batch (stands in for the reference's private table dump)."""
    rng = np.random.default_rng(seed)
    u_f = rng.normal(size=(n_users, rank))
    i_f = rng.normal(size=(n_items, rank))
    u = rng.integers(0, n_users, n_rows)
    i = rng.integers(0, n_items, n_rows)
    logit = (u_f[u] * i_f[i]).sum(axis=1) / np.sqrt(rank) - 0.5
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    # raw ids offset into a sparse int64 key space like real user ids
    return hash_demo_batch(u * 7919 + 13, i * 104729 + 7, y,
                           schema or demo_schema())
