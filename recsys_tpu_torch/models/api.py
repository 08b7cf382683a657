"""Model API (counterpart of ``recsys_tpu/models/api.py``): a model is a pair
of plain functions bound to a config.

    model = make_model(name, criteo_cfg, model_cfg)
    params, state = model.init(generator, device)
    logits, new_state = model.apply(params, state, batch, train=False)

- ``params``: nested dicts/lists of tensors, the JAX parameter tree's
  structure (``convert.py`` maps one onto the other).
- ``state``: non-trainable tree (batch-norm moving stats).
- ``batch``: {'ids': int64 [B, F] field-local ids,
              'dense': float32 [B, 13] log-scaled continuous values} for
  the Criteo models; DIN's is in ``models/din.py``, DLRM's multi-hot bags
  in ``models/dlrm.py``.
- ``logits``: float32 [B].
- ``meta``: static facts other modules need (DIN's ``sample_features``,
  the serving warm-up's request generator; the Criteo models' ``engine``,
  for the SPMD drivers' host-side capacity check).

Table reads go through an `EmbOps`, so the same model body runs with whole
tables (`LOCAL_EMB_OPS`, every model's default) or with row-sharded tables
inside the SPMD step (``parallel/spmd.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.parallel.collectives import Axis


@dataclass(frozen=True)
class EmbOps:
    """Pluggable embedding access: local (whole tables) or sharded.

    ``sharded=True`` routes the engine-backed models (the Criteo zoo)
    through ``engine.lookup_parts_sharded``, the dedup + all-to-all
    exchange over ``axis``, the mesh's model axis
    (``parallel/sharded_embedding.py``); ``linear`` serves the wide
    model, which owns its raw weights (DIN keeps its tables whole).
    ``a2a_exact`` sizes the exchange for the worst case
    (lossless); ``a2a_cap_factor`` sizes the non-exact capacity, beyond
    which ids read as zero rows: the SPMD drivers check sampled batches
    against it at startup and, for streams, periodically
    (``train/spmd_loop.py``), which catches skewed id-to-owner
    distributions with high probability but guarantees nothing; only
    ``a2a_exact=True`` is lossless by construction."""

    linear: Callable[[dict, Any], Any]
    sharded: bool = False
    a2a_exact: bool = False
    a2a_cap_factor: float = 2.0
    axis: Axis | None = None


LOCAL_EMB_OPS = EmbOps(linear=emb_table.linear_sum)


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable[..., tuple[Any, Any]]
    apply: Callable[..., tuple[Any, Any]]
    meta: dict = field(default_factory=dict)


_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_model(name: str, *args, **kwargs) -> Model:
    if name not in _REGISTRY:
        # import model modules lazily so registration happens on demand
        import recsys_tpu_torch.models.ctr  # noqa: F401
        import recsys_tpu_torch.models.din  # noqa: F401
        import recsys_tpu_torch.models.dlrm  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"model {name!r} is not ported; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)
