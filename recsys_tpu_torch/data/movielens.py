"""MovieLens data: ML-20M (VAE-CF protocol) and ML-100K (CDAE protocol).

Counterpart of ``recsys_tpu/data/movielens.py``: the same numpy and
``scipy.sparse`` code, so one seed gives the same arrays in both packages.
`load_ml20m` reads ``ratings.csv`` with numpy instead of pandas and hands
`preprocess_vae_cf` the same columns and types (int64 ids, float64
ratings).

Parity map:
- ML-20M preprocessing (vae-cf/vae_cf_preprocess.py:17-144): keep ratings
  > 3.5, drop users with < 5 interactions, hold out 10k users for validation
  and 10k for test, split each heldout user's items 80/20 into fold-in /
  heldout, re-index item ids by training occurrence.
- ML-100K loading (cade/movie_lens.py:9-63): ua.base/ua.test → binary
  user×item matrices.

Synthetic generators produce small datasets with planted low-rank structure
so the full training/eval protocol is testable without downloads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import sparse


@dataclass
class VaeCfData:
    train: sparse.csr_matrix          # [U_train, I] binary
    vad_tr: sparse.csr_matrix         # fold-in for validation users
    vad_te: sparse.csr_matrix         # heldout for validation users
    test_tr: sparse.csr_matrix
    test_te: sparse.csr_matrix
    n_items: int


def _split_train_test_proportion(rows, cols, n_items, test_prop=0.2,
                                 seed=98765):
    """Per-user 80/20 fold-in/heldout split (vae_cf_preprocess.py:86-107)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    tr_r, tr_c, te_r, te_c = [], [], [], []
    uniq, starts = np.unique(rows, return_index=True)
    starts = list(starts) + [len(rows)]
    for ui, u in enumerate(uniq):
        items = cols[starts[ui]:starts[ui + 1]]
        n = len(items)
        if n >= 5:
            idx = np.zeros(n, bool)
            idx[rng.choice(n, size=max(1, int(test_prop * n)),
                           replace=False)] = True
        else:
            idx = np.zeros(n, bool)
        tr_r.extend([ui] * int((~idx).sum()))
        tr_c.extend(items[~idx])
        te_r.extend([ui] * int(idx.sum()))
        te_c.extend(items[idx])
    n_users = len(uniq)
    mk = lambda r, c: sparse.csr_matrix(
        (np.ones(len(r), np.float32), (r, c)), shape=(n_users, n_items)
    )
    return mk(tr_r, tr_c), mk(te_r, te_c)


def preprocess_vae_cf(
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    ratings: np.ndarray | None = None,
    n_heldout_users: int = 10000,
    min_user_interactions: int = 5,
    rating_threshold: float = 3.5,
    seed: int = 98765,
) -> VaeCfData:
    """The full VAE-CF protocol over raw (user, item, rating) triplets."""
    if ratings is not None:
        keep = ratings > rating_threshold
        user_ids, item_ids = user_ids[keep], item_ids[keep]

    # drop light users
    u_unique, u_counts = np.unique(user_ids, return_counts=True)
    good = set(u_unique[u_counts >= min_user_interactions])
    keep = np.isin(user_ids, list(good))
    user_ids, item_ids = user_ids[keep], item_ids[keep]

    rng = np.random.default_rng(seed)
    users = np.unique(user_ids)
    rng.shuffle(users)
    n_users = len(users)
    n_h = min(n_heldout_users, n_users // 4)
    tr_users = set(users[: n_users - 2 * n_h])
    vd_users = set(users[n_users - 2 * n_h: n_users - n_h])
    te_users = set(users[n_users - n_h:])

    tr_mask = np.isin(user_ids, list(tr_users))
    # item vocabulary = items seen in training (vae_cf_preprocess.py:120-128)
    items = np.unique(item_ids[tr_mask])
    item2id = {it: i for i, it in enumerate(items)}
    n_items = len(items)

    def to_matrix_rows(mask):
        u = user_ids[mask]
        i = item_ids[mask]
        ok = np.isin(i, items)
        u, i = u[ok], i[ok]
        i = np.asarray([item2id[x] for x in i])
        return u, i

    tu, ti = to_matrix_rows(tr_mask)
    u2row = {u: r for r, u in enumerate(np.unique(tu))}
    rows = np.asarray([u2row[x] for x in tu])
    train = sparse.csr_matrix(
        (np.ones(len(rows), np.float32), (rows, ti)),
        shape=(len(u2row), n_items),
    )

    vu, vi = to_matrix_rows(np.isin(user_ids, list(vd_users)))
    vad_tr, vad_te = _split_train_test_proportion(vu, vi, n_items, seed=seed)
    su, si = to_matrix_rows(np.isin(user_ids, list(te_users)))
    test_tr, test_te = _split_train_test_proportion(su, si, n_items,
                                                    seed=seed + 1)
    return VaeCfData(train, vad_tr, vad_te, test_tr, test_te, n_items)


def load_ml20m(ratings_csv: str, **kw) -> VaeCfData:
    """ratings.csv (userId,movieId,rating,timestamp) → VaeCfData."""
    with open(ratings_csv) as f:
        header = f.readline().strip().split(",")
        cols = [header.index(c) for c in ("userId", "movieId", "rating")]
        table = np.loadtxt(f, delimiter=",", usecols=cols, dtype=np.float64,
                           ndmin=2)
    return preprocess_vae_cf(
        table[:, 0].astype(np.int64), table[:, 1].astype(np.int64),
        table[:, 2], **kw,
    )


def synthetic_interactions(
    n_users: int = 600, n_items: int = 300, rank: int = 6,
    density: float = 0.08, seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Planted low-rank user/item affinity → (users, items, ratings)."""
    rng = np.random.default_rng(seed)
    u_f = rng.normal(size=(n_users, rank))
    i_f = rng.normal(size=(n_items, rank))
    aff = u_f @ i_f.T / np.sqrt(rank)
    prob = density * np.exp(aff) / np.exp(aff).mean()
    picks = rng.random((n_users, n_items)) < np.clip(prob, 0, 0.9)
    users, items = np.nonzero(picks)
    # ratings skewed by affinity so the >3.5 filter keeps structure
    ratings = np.clip(
        np.round(3.5 + aff[users, items] + rng.normal(0, 0.5, len(users))),
        1, 5,
    )
    return users, items, ratings


# ---------------------------------------------------------------------------
# ML-100K (CDAE)
# ---------------------------------------------------------------------------

def load_ml100k(base_path: str, test_path: str,
                n_users: int = 943, n_items: int = 1682):
    """ua.base/ua.test (tab-separated u, i, r, t) → binary matrices
    (cade/movie_lens.py:9-63)."""
    def load(path):
        mat = np.zeros((n_users, n_items), np.float32)
        with open(path) as f:
            for line in f:
                u, i, r, _ = line.split("\t")
                mat[int(u) - 1, int(i) - 1] = 1.0
        return mat

    train_x = load(base_path)
    test_x = load(test_path)
    users = np.arange(n_users, dtype=np.int32)
    return users, train_x, users, test_x


def synthetic_ml100k(n_users: int = 200, n_items: int = 120, seed: int = 0):
    """Binary train/test matrices with shared low-rank structure."""
    users_r, items_r, _ = synthetic_interactions(
        n_users, n_items, density=0.15, seed=seed)
    full = np.zeros((n_users, n_items), np.float32)
    full[users_r, items_r] = 1.0
    rng = np.random.default_rng(seed + 1)
    test_mask = (rng.random(full.shape) < 0.2) & (full > 0)
    train_x = full * (~test_mask)
    test_x = full * test_mask
    users = np.arange(n_users, dtype=np.int32)
    return users, train_x, users, test_x
