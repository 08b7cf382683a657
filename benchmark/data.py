"""The training set, made on the device from the seed: the benchmark's own
torch copy of the arithmetic of ``synthetic_criteo``
(``recsys_tpu_torch/data/criteo.py``), which it neither imports nor calls.

Each field's ids are ``floor(vocab · u^skew)`` for ``u`` uniform on [0, 1):
hot rows at the front of every vocabulary. The labels come from a planted
logistic model over the same rows:

    logit = bias + Σ_f effect_f[id_f] + Σ_{f<g} <U_f[id_f], U_g[id_g]>
          + w · log1p(dense)

with ``dense`` log-normal. The set is handed to the port in the types that
``fast.stage_dataset`` gives it: int64 ids [N, F], float32 dense [N, 13] and
float32 labels [N], 368 bytes a row at the Criteo schema.
"""

from __future__ import annotations

import torch

from benchmark import draws
from benchmark.models import criteo


def make_dataset(config: dict, traffic: dict, seed: int, device,
                 rows: int | None = None) -> dict[str, torch.Tensor]:
    """{'ids', 'dense', 'label'} of ``traffic['rows']`` rows (or ``rows``)
    on ``device``, the same for the same seed."""
    n = traffic["rows"] if rows is None else rows
    vocabs = criteo.field_vocabs(config)
    n_dense = len(config["cont_boundaries"])
    planted = traffic["planted"]
    k = planted["interaction_rank"]
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.stream_seed(seed, "data"))

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    ids = torch.empty((n, len(vocabs)), dtype=torch.int64, device=device)
    logit = torch.full((n,), planted["bias"], dtype=torch.float32,
                       device=device)
    lat_sum = torch.zeros((n, k), dtype=torch.float32, device=device)
    lat_sq = torch.zeros((n,), dtype=torch.float32, device=device)
    for f, vocab in enumerate(vocabs):
        u = torch.rand((n,), generator=gen, device=device)
        raw = u.pow_(traffic["id_skew"]).mul_(vocab).floor_().to(torch.int64)
        raw.clamp_(max=vocab - 1)
        del u
        ids[:, f] = raw
        logit += normal(vocab, scale=planted["effect_scale"])[raw]
        rows_k = normal(vocab, k, scale=planted["interaction_scale"])[raw]
        lat_sum += rows_k
        lat_sq += rows_k.square().sum(dim=1)
        del raw, rows_k
    # Σ_{f<g} <u_f, u_g> by the FM identity ½(‖Σu‖² − Σ‖u‖²)
    logit += 0.5 * (lat_sum.square().sum(dim=1) - lat_sq)
    del lat_sum, lat_sq
    dense = torch.log1p(torch.randn((n, n_dense), generator=gen,
                                    device=device).exp_())
    logit += dense @ normal(n_dense, scale=planted["dense_scale"])
    label = (torch.rand((n,), generator=gen, device=device)
             < torch.sigmoid(logit)).to(torch.float32)
    return {"ids": ids, "dense": dense, "label": label}
