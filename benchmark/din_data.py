"""The DIN cell's training set, made on the device from the seed: rows of
MovieLens-20M's shape (DIN, arXiv:1706.06978 §6.1), each a rated movie with
the user's earlier movies as its history. The benchmark's own torch code:
it imports nothing of the port.

- Users: ``traffic['users']``. User u rates ``n_u`` movies,
  ``clamp(round(exp(ln median + sigma·z)), min, max)`` with z standard
  normal; ``sigma`` is fitted so that the expected rows (`expected_law`)
  are the paper's training samples.
- Every rating is a row. Its target is the rated item; its history the
  user's earlier items, the most recent ``max_hist`` (the configuration's)
  of them in the order
  they were rated, left-aligned and zero-padded to ``max_hist`` (the
  port's loader, ``recsys_tpu_torch/data/amazon.py`` ``build_examples``,
  lays histories out so). A user's first row has an empty history.
- Item ids are ``1 + floor((V − 1)·u^item_skew)`` for ``u`` uniform on
  [0, 1): hot items first, id 0 is the padding. Each item has one of
  ``categories`` categories (ids 1..C, 0 the padding), by a map drawn from
  the seed.
- Labels: a planted logistic model over the target and its history,

      logit = bias + effect[target] + interest · <U[target], mean_h U[h]>

  with ``U`` an item factor of rank ``factor_rank`` and the mean over the
  history's real positions (0 for an empty one): an item near the user's
  past is liked, which target attention can find.

The set is handed to the port in the types that ``fast.stage_dataset``
gives it: int64 ids and histories, float32 labels, 2,068 bytes a row at
``max_hist`` 128.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import draws

#: rows built at once: their [rows, max_hist] index and mask temporaries
#: are all the generator holds beside the set
CHUNK_ROWS = 1 << 18


def rating_counts(traffic: dict, gen: torch.Generator, device):
    """[users] int64: each user's number of ratings, by the law."""
    z = torch.randn((traffic["users"],), generator=gen, device=device,
                    dtype=torch.float64)
    n = torch.exp(math.log(traffic["ratings_median"])
                  + traffic["ratings_sigma"] * z).round_()
    return n.clamp_(traffic["ratings_min"], traffic["ratings_max"]).to(
        torch.int64)


def make_dataset(config: dict, traffic: dict, seed: int,
                 device) -> dict[str, torch.Tensor]:
    """{'i_id', 'i_cate' [N] int64, 'hist_iid', 'hist_cate' [N, P] int64,
    'label' [N] float32} on ``device``, the same for the same seed."""
    p, v = config["max_hist"], config["item_vocab"]
    planted = traffic["planted"]
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.stream_seed(seed, "data"))
    counts = rating_counts(traffic, gen, device)
    n = int(counts.sum())
    # every rating's item, users one after the other, each in rating order
    u = torch.rand((n,), generator=gen, device=device, dtype=torch.float64)
    items = (u.pow_(traffic["item_skew"]).mul_(v - 1).floor_()
             .to(torch.int64).clamp_(max=v - 2).add_(1))
    del u
    cate_of = torch.randint(1, traffic["categories"] + 1, (v,),
                            generator=gen, device=device)
    cate_of[0] = 0
    effect = torch.randn((v,), generator=gen,
                         device=device).mul_(planted["effect_scale"])
    factor = torch.randn((v, planted["factor_rank"]), generator=gen,
                         device=device).mul_(planted["factor_scale"])
    # each row's place in its user's ratings, and its history's length
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    length = (torch.arange(n, device=device) - first).clamp_(max=p)
    del first
    # Σ of the factors of every earlier rating: a history's sum is a
    # difference of two of these (float64, exact enough over 14M rows)
    before = torch.zeros((n + 1, factor.shape[1]), dtype=torch.float64,
                         device=device)
    torch.cumsum(factor[items].double(), 0, out=before[1:])
    rows = torch.arange(n, device=device)
    hist_sum = (before[rows] - before[rows - length]).float()
    del before
    mean_hist = hist_sum / length.clamp(min=1)[:, None].float()
    logit = (planted["bias"] + effect[items]
             + planted["interest"] * (factor[items] * mean_hist).sum(dim=1))
    del hist_sum, mean_hist
    label = (torch.rand((n,), generator=gen, device=device)
             < torch.sigmoid(logit)).to(torch.float32)
    del logit
    hist_iid = torch.empty((n, p), dtype=torch.int64, device=device)
    hist_cate = torch.empty((n, p), dtype=torch.int64, device=device)
    j = torch.arange(p, device=device)
    for lo in range(0, n, CHUNK_ROWS):
        hi = min(lo + CHUNK_ROWS, n)
        ln = length[lo:hi, None]
        src = (rows[lo:hi, None] - ln + j).clamp_(max=n - 1)
        got = torch.where(j < ln, items[src], 0)
        hist_iid[lo:hi] = got
        hist_cate[lo:hi] = cate_of[got]
        del ln, src, got
    return {"i_id": items, "i_cate": cate_of[items], "hist_iid": hist_iid,
            "hist_cate": hist_cate, "label": label}


def expected_law(config: dict, traffic: dict,
                 points: int = 200_001) -> dict:
    """What the rating law gives on average, worked out on the host without
    building a set: {'rows': expected rows, 'padding': the expected share
    of history positions that are padding, 'capped': the share of rows
    whose history fills all ``max_hist`` positions}."""
    z = np.linspace(-9.0, 9.0, points)
    w = np.exp(-0.5 * z * z)
    w /= w.sum()
    n = np.clip(np.round(np.exp(math.log(traffic["ratings_median"])
                                + traffic["ratings_sigma"] * z)),
                traffic["ratings_min"], traffic["ratings_max"])
    p = config["max_hist"]
    # a user of n ratings: rows k = 0..n−1, each with P − min(k, P) pads
    pads = np.where(n <= p, p * n - n * (n - 1) / 2, p * (p + 1) / 2)
    mean = float((w * n).sum())
    return {"rows": traffic["users"] * mean,
            "padding": float((w * pads).sum()) / (p * mean),
            "capped": float((w * np.maximum(n - p, 0)).sum()) / mean}
