"""Typed configuration system.

Replaces the reference's per-script ``tf.app.flags`` blocks (e.g.
``fm/fm.py:16-37``, ``xdeepfm/xdeepfm.py:12-34``, ``din/din.py:12-40``) and
module-level constant blocks (``ftrl/ftrl.py:29-47``) with one set of typed,
composable dataclasses plus a small CLI override parser.

The Criteo feature statics (quantile bucket boundaries and per-field hashed
vocab caps) that the reference re-declares in every script
(``fm/fm.py:54-73``, ``dcn/dcn.py:51-70``, ``xdeepfm/xdeepfm.py:51-70``,
``deep&wide/deep&wide.py``) live here once, as data.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# Criteo feature statics (reference: fm/fm.py:54-73 — identical in all clones)
# ---------------------------------------------------------------------------

#: Quantile boundaries for the 13 continuous Criteo fields (_c1.._c13),
#: applied AFTER the log transform is NOT applied — the reference bucketizes
#: the log-normalized numeric column against raw-valued boundaries
#: (``tf.feature_column.bucketized_column(f_num, j)`` where ``f_num`` carries
#: ``normalizer_fn=log(x+1)`` — fm/fm.py:76-79). We reproduce exactly that:
#: bucketize(log1p(x), boundaries) with these *raw-looking* boundary lists.
CRITEO_CONT_BOUNDARIES: tuple[tuple[float, ...], ...] = (
    (0.0, 1.0, 2.0, 3.0, 5.0, 12.0),
    (0.0, 1.0, 2.0, 4.0, 10.0, 28.0, 76.0, 301.0),
    (1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 16.0, 24.0, 54.0),
    (1.0, 2.0, 3.0, 5.0, 6.0, 9.0, 13.0, 20.0),
    (20.0, 155.0, 1087.0, 1612.0, 2936.0, 5064.0, 8622.0, 16966.0, 39157.0),
    (3.0, 7.0, 13.0, 24.0, 36.0, 53.0, 85.0, 154.0, 411.0),
    (0.0, 1.0, 2.0, 4.0, 6.0, 10.0, 17.0, 43.0),
    (1.0, 2.0, 4.0, 6.0, 8.0, 12.0, 17.0, 25.0, 37.0),
    (4.0, 8.0, 16.0, 28.0, 41.0, 63.0, 109.0, 147.0, 321.0),
    (0.0, 1.0, 2.0),
    (0.0, 1.0, 2.0, 3.0, 4.0, 8.0),
    (0.0, 1.0, 2.0),
    (1.0, 2.0, 3.0, 5.0, 7.0, 10.0, 14.0, 22.0),
)

#: Hash-bucket sizes for the 26 categorical fields (_c14.._c39) with the
#: reference's 100k caps on the six giant fields (fm/fm.py:72-73 — the second
#: literal overrides the true vocab sizes; that override is the behavior the
#: published AUC numbers were measured with, so it is the default here).
CRITEO_CAT_VOCABS: tuple[int, ...] = (
    1460, 583, 100000, 100000, 305, 23, 12517, 633, 3, 93145, 5683, 100000,
    3194, 27, 14992, 100000, 10, 5652, 2172, 3, 100000, 17, 15, 100000, 104,
    100000,
)

#: Uncapped (true Criteo) vocab sizes — the first, shadowed literal
#: (fm/fm.py:69-70), kept available for full-vocab experiments.
CRITEO_CAT_VOCABS_FULL: tuple[int, ...] = (
    1460, 583, 10131226, 2202607, 305, 23, 12517, 633, 3, 93145, 5683,
    8351592, 3194, 27, 14992, 5461305, 10, 5652, 2172, 3, 7046546, 17, 15,
    286180, 104, 142571,
)

NUM_CONT_FIELDS = 13
NUM_CAT_FIELDS = 26
NUM_FIELDS = NUM_CONT_FIELDS + NUM_CAT_FIELDS  # 39


def cont_bucket_sizes() -> tuple[int, ...]:
    """Number of buckets per continuous field: len(boundaries)+1."""
    return tuple(len(b) + 1 for b in CRITEO_CONT_BOUNDARIES)


# ---------------------------------------------------------------------------
# Config dataclasses
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CriteoConfig:
    """Criteo dataset + feature-engineering config (replaces L0/L2 statics)."""

    cont_boundaries: tuple[tuple[float, ...], ...] = CRITEO_CONT_BOUNDARIES
    cat_vocabs: tuple[int, ...] = CRITEO_CAT_VOCABS
    #: log(x + shift) per continuous field; _c2 uses shift 4.0 (fm/fm.py:77-78)
    log_shift_default: float = 1.0
    log_shift_c2: float = 4.0
    #: Missing categorical values map to the hash of this token (fm/fm.py:44)
    null_token: str = "NULL"

    @property
    def cont_bucket_sizes(self) -> tuple[int, ...]:
        return tuple(len(b) + 1 for b in self.cont_boundaries)

    @property
    def field_vocab_sizes(self) -> tuple[int, ...]:
        """Vocab size of every one of the 39 fields, continuous first."""
        return self.cont_bucket_sizes + self.cat_vocabs

    @property
    def total_vocab(self) -> int:
        return sum(self.field_vocab_sizes)


@dataclass(frozen=True)
class EmbeddingConfig:
    """Unified embedding-table config (replaces feature_column embeddings)."""

    field_vocab_sizes: tuple[int, ...]
    embedding_dim: int = 16
    #: 'replicated' (table copied per chip, DP only) or 'row' (row-sharded
    #: across the 'model' mesh axis with collective combine — SURVEY §2.2).
    sharding: str = "replicated"
    #: Parameter dtype for tables.
    dtype: str = "float32"

    @property
    def num_fields(self) -> int:
        return len(self.field_vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return sum(self.field_vocab_sizes)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh config: replaces MirroredStrategy (deepfm/deepfm.py:159-169).

    Axis 'data' carries batch (DP); axis 'model' carries embedding-row
    sharding (the genuine model parallelism a CTR workload needs, SURVEY
    §2.3).
    """

    data_axis: int = -1  # -1: all available devices
    model_axis: int = 1
    axis_names: tuple[str, str] = ("data", "model")
    #: size the sharded-embedding all-to-all for the worst case (lossless,
    #: larger collectives) instead of ``a2a_cap_factor``
    a2a_exact: bool = False
    #: per-owner id capacity factor of the non-exact a2a exchange
    #: (parallel/sharded_embedding.a2a_capacity)
    a2a_cap_factor: float = 2.0
    #: what the SPMD driver does when its startup check finds the observed
    #: id distribution would overflow ``a2a_cap_factor`` (silently dropping
    #: rows): 'check' = fail loudly with guidance, 'auto' = upgrade this
    #: run to exact capacity, 'off' = skip the check (trust the factor)
    a2a_policy: str = "check"


@dataclass(frozen=True)
class ModelConfig:
    """Per-model hyperparameters (union of the reference's flag groups)."""

    name: str = "deepfm"
    embedding_dim: int = 16
    deep_layers: tuple[int, ...] = (100, 100)  # README.md:34
    cross_layers: int = 4  # dcn/dcn.py:24 default
    cin_layers: tuple[int, ...] = (20, 10, 10)  # xdeepfm/xdeepfm.py:19
    attention_layers: tuple[int, ...] = (80, 40)  # din/din.py:85
    mlp_layers: tuple[int, ...] = (100, 50, 20)  # din/din.py:86
    dropout: float = 0.5
    use_bn: bool = True
    #: compute dtype for the dense towers ('bfloat16' rides the MXU)
    compute_dtype: str = "float32"
    #: embedding engine (recsys_tpu.embeddings.engines): 'split' (default —
    #: small-vocab fields via one MXU one-hot matmul, big fields via packed
    #: gather + Pallas scatter backward) or 'fused' (everything through the
    #: single packed gather).
    emb_engine: str = "split"
    #: vocab-size cutoff between the split engine's matmul and gather paths
    split_threshold: int = 2048


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop config (replaces RunConfig + flags)."""

    batch_size: int = 256
    learning_rate: float = 1e-3
    num_epochs: int = 5
    num_steps: int = -1  # -1: derive from epochs × data size
    eval_steps: int = 200  # xdeepfm/xdeepfm.py:31
    eval_every_steps: int = 2000
    log_every_steps: int = 100
    save_checkpoints_steps: int = 1000
    keep_checkpoint_max: int = 5  # fm/fm.py:189
    shuffle_buffer: int = 1000
    seed: int = 42
    model_dir: str = "./model"


@dataclass(frozen=True)
class RunConfig:
    """One run = dataset + model + train + mesh."""

    criteo: CriteoConfig = field(default_factory=CriteoConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# CLI override parsing:  --train.batch_size=8192 --model.name=dcn
# ---------------------------------------------------------------------------


def _coerce(value: str, target_type: Any) -> Any:
    if target_type is bool:
        return value.lower() in ("1", "true", "yes")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type in (tuple, list) or str(target_type).startswith(
        ("tuple", "typing.Tuple", "list")
    ):
        if value.strip() == "":
            return ()
        return tuple(
            int(v) if v.strip().lstrip("-").isdigit() else float(v)
            for v in value.split(",")
        )
    return value


def apply_overrides(cfg: RunConfig, overrides: Sequence[str]) -> RunConfig:
    """Apply ``--section.key=value`` CLI overrides to a RunConfig."""
    updates: dict[str, dict[str, Any]] = {}
    for ov in overrides:
        if not ov.startswith("--"):
            raise ValueError(f"bad override (want --section.key=value): {ov}")
        body = ov[2:]
        key, _, value = body.partition("=")
        section, _, attr = key.partition(".")
        if not attr:
            raise ValueError(f"bad override key (want section.key): {key}")
        updates.setdefault(section, {})[attr] = value

    result = cfg
    for section, kv in updates.items():
        sub = getattr(result, section)
        fields = {f.name: f.type for f in dataclasses.fields(sub)}
        coerced = {}
        for attr, raw in kv.items():
            if attr not in fields:
                raise ValueError(f"unknown config field {section}.{attr}")
            current = getattr(sub, attr)
            coerced[attr] = _coerce(raw, type(current))
        result = dataclasses.replace(result, **{section: dataclasses.replace(sub, **coerced)})
    return result


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)
