"""The system under test in the DIN cell: the port's ``din`` model
(``recsys_tpu_torch/models/din.py``) built through ``models.api.make_model``
at the configuration's widths and vocabularies, and what it counts on the
card. The train state and the graphed K-step call are `port`'s, as in the
Criteo cells.
"""

from __future__ import annotations

from recsys_tpu_torch.core.config import ModelConfig
from recsys_tpu_torch.models.api import make_model


def model(config: dict):
    """The port's DIN of ``config``."""
    cfg = ModelConfig(
        name="din", embedding_dim=config["embedding_dim"],
        attention_layers=tuple(config["attention_layers"]),
        mlp_layers=tuple(config["mlp_layers"]), dropout=config["dropout"],
        use_bn=config["use_bn"], compute_dtype=config["dtype"])
    return make_model("din", config["item_vocab"], config["cate_vocab"], cfg)


def attention_counts(m, device) -> dict | None:
    """{'rows', 'real'} that the model's attention units have counted on
    ``device`` so far (one host read), or None where the port counts
    none."""
    counter = m.meta.get("attention_counter")
    return None if counter is None else counter.totals(device)
