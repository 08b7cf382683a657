"""Model API (counterpart of ``recsys_tpu/models/api.py``): a model is a pair
of plain functions bound to a config.

    model = make_model(name, criteo_cfg, model_cfg)
    params, state = model.init(generator, device)
    logits, new_state = model.apply(params, state, batch, train=False)

- ``params``: nested dicts/lists of tensors, the JAX parameter tree's
  structure (``convert.py`` maps one onto the other).
- ``state``: non-trainable tree (batch-norm moving stats).
- ``batch``: {'ids': int64 [B, F] field-local ids,
              'dense': float32 [B, 13] log-scaled continuous values}.
- ``logits``: float32 [B].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable[..., tuple[Any, Any]]
    apply: Callable[..., tuple[Any, Any]]


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
    if name not in _REGISTRY:
        raise ValueError(f"model {name!r} is not ported; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](*args, **kwargs)
