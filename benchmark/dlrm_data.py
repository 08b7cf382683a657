"""The DLRM cell's training set, made on the device from the seed: rows of
MLPerf's multi-hot Criteo 1TB shape (26 bags of ``multi_hot_sizes`` ids,
13 dense values, a label), with the ids drawn from the rows this card
holds of each field. The benchmark's own torch code: it imports nothing of
the port.

- A bag's first id is ``floor(V · u^id_skew)`` for ``u`` uniform on
  [0, 1) (the Criteo cells' law, `data`: hot rows at the front of each
  table); its other ids are uniform over the V rows held (MLPerf's
  synthetic multi-hot set adds its hots uniformly).
- Dense values: ``log1p`` of a log-normal, as `data`'s.
- Labels: a planted logistic model over each field's bag, as `data`'s over
  one id a field:

      logit = bias + Σ_f mean_bag effect_f + Σ_{f<g} <ū_f, ū_g>
              + w · dense

  with ū_f the mean over field f's bag of a rank-k factor of each row.

The set is handed to the port in the types that ``fast.stage_dataset``
gives it: int64 ids [N, S], float32 dense [N, 13] and float32 labels [N],
1,768 bytes a row at S = 214.
"""

from __future__ import annotations

import torch

from benchmark import draws
from benchmark.models import dlrm


def make_dataset(config: dict, traffic: dict, seed: int, device,
                 rows: int | None = None) -> dict[str, torch.Tensor]:
    """{'ids' [N, S] field-local int64, 'dense' [N, 13], 'label' [N]} of
    ``traffic['rows']`` rows (or ``rows``) on ``device``, the same for the
    same seed."""
    n = traffic["rows"] if rows is None else rows
    planted = traffic["planted"]
    k = planted["interaction_rank"]
    bags = dlrm.bag_sizes(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.stream_seed(seed, "data"))

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    ids = torch.empty((n, sum(bags)), dtype=torch.int64, device=device)
    logit = torch.full((n,), planted["bias"], dtype=torch.float32,
                       device=device)
    lat_sum = torch.zeros((n, k), dtype=torch.float32, device=device)
    lat_sq = torch.zeros((n,), dtype=torch.float32, device=device)
    slot = 0
    for vocab, size in zip(dlrm.vocabs(config), bags):
        effect = normal(vocab, scale=planted["effect_scale"])
        factor = normal(vocab, k, scale=planted["interaction_scale"])
        eff = torch.zeros((n,), dtype=torch.float32, device=device)
        lat = torch.zeros((n, k), dtype=torch.float32, device=device)
        for j in range(size):
            u = torch.rand((n,), generator=gen, device=device)
            if j == 0:
                u.pow_(traffic["id_skew"])
            raw = u.mul_(vocab).floor_().to(torch.int64).clamp_(max=vocab - 1)
            del u
            ids[:, slot + j] = raw
            eff += effect[raw]
            lat += factor[raw]
            del raw
        logit += eff.div_(size)
        lat.div_(size)
        lat_sum += lat
        lat_sq += lat.square().sum(dim=1)
        slot += size
        del effect, factor, eff, lat
    # Σ_{f<g} <ū_f, ū_g> by the FM identity ½(‖Σū‖² − Σ‖ū‖²)
    logit += 0.5 * (lat_sum.square().sum(dim=1) - lat_sq)
    del lat_sum, lat_sq
    n_dense = config["num_dense_features"]
    dense = torch.log1p(torch.randn((n, n_dense), generator=gen,
                                    device=device).exp_())
    logit += dense @ normal(n_dense, scale=planted["dense_scale"])
    label = (torch.rand((n,), generator=gen, device=device)
             < torch.sigmoid(logit)).to(torch.float32)
    return {"ids": ids, "dense": dense, "label": label}
