"""VAE-CF training command line (counterpart of
``recsys_tpu/tools/train_vae.py``; the reference's
vae-cf/vae_cf_train_val.py as an explicit entry point).

    python -m recsys_tpu_torch.tools.train_vae --device=cuda \
        [--ratings_csv=/path/to/ml-20m/ratings.csv] \
        [--model=multi_vae|multi_dae|logistic_vae] \
        [--epochs=200] [--batch_size=500] [--anneal_cap=0.2] \
        [--total_anneal_steps=200000] [--model_dir=./vae_model] \
        [--n_heldout_users=10000]

The flags are the JAX command's: every field of `VaeTrainConfig`, and
``--ratings_csv`` or, without it, the planted synthetic interactions of
``--synthetic_users`` users over ``--synthetic_items`` items
(``--n_heldout_users``, ``--rating_threshold``). ``--device`` is ``cuda``
(the default; it fails without a card and never falls back) or ``cpu``.
Prints one JSON line with the best validation NDCG@100, its epoch and
step, and the restored best checkpoint's test metrics (NDCG@100 /
Recall@20 / Recall@50).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys

from recsys_tpu_torch.data import movielens as ML
from recsys_tpu_torch.tools.train_ctr import device_from_flag
from recsys_tpu_torch.train.vae_loop import VaeTrainConfig, train_vae_cf


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    device = device_from_flag(kv.get("device", "cuda"))

    cfg = VaeTrainConfig()
    fields = {f.name: type(getattr(cfg, f.name))
              for f in dataclasses.fields(cfg)}
    cfg = dataclasses.replace(cfg, **{k: fields[k](v) for k, v in kv.items()
                                      if k in fields})

    if "ratings_csv" in kv:
        data = ML.load_ml20m(
            kv["ratings_csv"],
            n_heldout_users=int(kv.get("n_heldout_users", 10000)),
        )
    else:
        u, i, r = ML.synthetic_interactions(
            n_users=int(kv.get("synthetic_users", 600)),
            n_items=int(kv.get("synthetic_items", 300)),
            seed=cfg.seed,
        )
        data = ML.preprocess_vae_cf(
            u, i, r, n_heldout_users=int(kv.get("n_heldout_users", 80)),
            rating_threshold=float(kv.get("rating_threshold", 3.5)),
        )

    result = train_vae_cf(data, cfg, device=device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
