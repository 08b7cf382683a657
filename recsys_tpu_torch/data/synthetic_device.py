"""The planted synthetic-Criteo task sampled on the device (counterpart of
``recsys_tpu/data/synthetic_device.py``), and its three computable
ceilings.

The host generator (`criteo.synthetic_criteo`) plants a sparse logistic
ground truth:

    logit = bias + Σ_f effect_f[id_f] + Σ_{f<g} <U_f[id_f], U_g[id_g]>
          + w·dense

`planted_tables` draws those parameters with the host generator's own
numpy streams (bitwise its arrays), and `make_device_sampler` draws fresh
rows from the same distribution on the card, so a training step can take a
new batch every step with nothing crossing from the host: one-pass online
training on the population (`fast.make_scanned_train_step_sampler`,
`tools/converge.py`). Only the draws differ from the host's (PyTorch's
Philox against numpy's PCG64); the arithmetic that turns draws into a
batch (`planted_batch`) is the JAX package's, kept apart from the draws
(`draw`) so that both can be fed the same ones.

Three ceilings score a trained model (host numpy, as in the JAX package;
the AUC exact, `metrics.roc_auc`):

- the full Bayes ceiling (`criteo.synthetic_bayes_metrics`) scores the
  true probabilities; only a model that reads the raw dense values can
  reach it (of the zoo, xDeepFM's linear branch);
- the id-only ceiling (`idonly_bayes_metrics`) scores E[y | ids], the best
  of a model that reads only the 39 ids (FM, DeepFM, DCN, DNN);
- the linear ceiling (`linear_bayes_metrics`) is the best additive model
  (the wide model's class): the planted task is second order, so linear <
  id-only, and the gap is the interaction structure.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.data.criteo import SyntheticSpec, synthetic_criteo
from recsys_tpu_torch.train.metrics import roc_auc

#: the samplers' id skew: ``floor(V·u^ZIPF_POWER) mod V`` with u ~ U[0, 1)
ZIPF_POWER = 2.2


def planted_tables(cfg: CriteoConfig = CriteoConfig(),
                   spec: SyntheticSpec = SyntheticSpec()
                   ) -> dict[str, np.ndarray]:
    """The planted ground truth, bitwise the host generator's streams
    (per field ``default_rng([seed, 31·f+1])`` effects and
    ``default_rng([seed, 31·f+2])`` interaction latents,
    ``default_rng([seed, 999])`` dense weights); ``eff_lat`` packs each
    row's effect and latents, the one table the sampler reads."""
    field_vocabs = cfg.field_vocab_sizes
    effects = np.concatenate([
        np.random.default_rng([spec.seed, 31 * f + 1]).normal(
            0.0, spec.effect_scale, vocab)
        for f, vocab in enumerate(field_vocabs)
    ]).astype(np.float32)
    k = spec.interaction_rank if spec.interaction_scale else 0
    latents = np.concatenate([
        np.random.default_rng([spec.seed, 31 * f + 2]).normal(
            0.0, spec.interaction_scale, (vocab, k))
        for f, vocab in enumerate(field_vocabs)
    ]).astype(np.float32) if k else np.zeros((sum(field_vocabs), 1),
                                             np.float32)
    w_dense = np.random.default_rng([spec.seed, 999]).normal(
        0.0, spec.dense_scale, len(cfg.cont_boundaries)).astype(np.float32)
    offsets = np.cumsum([0] + list(field_vocabs[:-1])).astype(np.int32)
    return {
        "effects": effects,                                   # [Σ vocab]
        "latents": latents,                                   # [Σ vocab, k]
        "eff_lat": np.concatenate([effects[:, None], latents], axis=1),
        "w_dense": w_dense,                                   # [13]
        "offsets": offsets,                                   # [39]
        "vocabs": np.asarray(field_vocabs, np.float32),       # [39]
        "vocabs_i": np.asarray(field_vocabs, np.int32),       # [39]
    }


def device_tables(tables: dict[str, np.ndarray], device) -> dict:
    """The tables the sampler reads, on ``device`` (~3.4 MB at full width):
    ``eff_lat``, ``w_dense``, ``vocabs`` as float32, ``offsets`` and
    ``vocabs_i`` as int64 (the gathers' index type)."""
    out = {}
    for k in ("eff_lat", "w_dense", "vocabs", "offsets", "vocabs_i"):
        t = torch.from_numpy(np.ascontiguousarray(tables[k]))
        out[k] = (t.to(torch.int64) if k in ("offsets", "vocabs_i")
                  else t).to(device)
    return out


def draw(gen: torch.Generator, batch_size: int, n_fields: int, n_cont: int,
         device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch's draws from ``gen``, in this order: the ids' uniforms
    [B, F], the dense values' standard normals [B, n_cont], the labels'
    uniforms [B] (float32, on ``device``)."""
    u = torch.rand((batch_size, n_fields), generator=gen, device=device)
    z = torch.randn((batch_size, n_cont), generator=gen, device=device)
    ul = torch.rand((batch_size,), generator=gen, device=device)
    return u, z, ul


def planted_logit(tables: dict, ids: torch.Tensor, dense: torch.Tensor,
                  spec: SyntheticSpec = SyntheticSpec()) -> torch.Tensor:
    """The planted logit of a batch [B]: bias + the rows' effects + the
    dense term + the pairwise term by the FM identity ½(‖Σu‖² − Σ‖u‖²),
    read from ``eff_lat`` with one row gather per field."""
    rows = tables["eff_lat"][ids + tables["offsets"]]      # [B, F, 1+k]
    logit = (spec.bias + rows[:, :, 0].sum(dim=1)
             + dense @ tables["w_dense"])
    if spec.interaction_rank and spec.interaction_scale:
        lat = rows[:, :, 1:]                               # [B, F, k]
        s = lat.sum(dim=1)                                 # [B, k]
        logit = logit + 0.5 * ((s * s).sum(dim=1)
                               - (lat * lat).sum(dim=(1, 2)))
    return logit


def planted_batch(tables: dict, u: torch.Tensor, z: torch.Tensor,
                  ul: torch.Tensor,
                  spec: SyntheticSpec = SyntheticSpec()) -> dict:
    """The batch that the draws (`draw`) give, by the JAX sampler's
    arithmetic: ids ``floor(V·u^2.2) mod V``, dense softplus(z) (= log1p
    of a log-normal draw), label ``ul < sigmoid(`planted_logit`)``."""
    raw = torch.floor(tables["vocabs"] * u ** ZIPF_POWER).to(torch.int64)
    ids = raw % tables["vocabs_i"]
    dense = torch.nn.functional.softplus(z)
    logit = planted_logit(tables, ids, dense, spec)
    label = (ul < torch.sigmoid(logit)).to(torch.float32)
    return {"ids": ids, "dense": dense, "label": label}


def make_device_sampler(cfg: CriteoConfig = CriteoConfig(),
                        spec: SyntheticSpec = SyntheticSpec()):
    """→ ``sample(gen, tables, batch_size) -> batch``: a fresh batch of the
    planted distribution drawn on the tables' device from ``gen``
    (`draw`, then `planted_batch`). It reads nothing on the host, so a
    captured training step may hold it."""
    n_fields = len(cfg.field_vocab_sizes)
    n_cont = len(cfg.cont_boundaries)

    def sample(gen: torch.Generator, tables: dict, batch_size: int) -> dict:
        u, z, ul = draw(gen, batch_size, n_fields, n_cont,
                        tables["eff_lat"].device)
        return planted_batch(tables, u, z, ul, spec)

    return sample


def _pairwise_term(latents: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """Σ_{f<g} <U_f[id_f], U_g[id_g]> per row, via ½(‖Σu‖² − Σ‖u‖²)."""
    rows = latents[gids]                                     # [N, F, k]
    s = rows.sum(axis=1)                                     # [N, k]
    return 0.5 * (np.einsum("nk,nk->n", s, s)
                  - np.einsum("nfk,nfk->n", rows, rows))


def zipf_marginals(vocab: int, power: float = ZIPF_POWER) -> np.ndarray:
    """Exact per-id probabilities of the samplers' draw
    ``floor(V·u^power) mod V``, u ~ U[0, 1):
    p_i = ((i+1)/V)^(1/power) − (i/V)^(1/power)."""
    grid = (np.arange(vocab + 1, dtype=np.float64) / vocab) ** (1.0 / power)
    return np.diff(grid)


def _mc_logloss(g: np.ndarray, r: np.ndarray, y: np.ndarray,
                chunk: int) -> float:
    """Mean logloss of p = mean_j sigmoid(g_i + r_j), clipped to [1e-12,
    1 − 1e-12], over rows in chunks of ``chunk`` (a [chunk, len(r)] float64
    matrix each)."""
    ll_sum = 0.0
    for lo in range(0, len(g), chunk):
        p = 1.0 / (1.0 + np.exp(-(g[lo:lo + chunk, None] + r[None, :])))
        p = np.clip(p.mean(axis=1), 1e-12, 1 - 1e-12)
        yc = y[lo:lo + chunk]
        ll_sum += float(-np.sum(yc * np.log(p) + (1 - yc) * np.log(1 - p)))
    return ll_sum / len(g)


def idonly_bayes_metrics(num_rows: int, cfg: CriteoConfig = CriteoConfig(),
                         spec: SyntheticSpec = SyntheticSpec(),
                         start_row: int = 0, mc_samples: int = 512,
                         chunk: int = 65536) -> dict[str, float]:
    """AUC and logloss ceiling of a model that reads only the 39 ids on the
    slice ``synthetic_criteo(num_rows, start_row=start_row)``.

    The best id-only predictor is E[y | ids] = E_z[sigmoid(l + z)] with z =
    w·dense independent of the ids; it is monotone in the id logit l, so
    the AUC is scored on l, and the logloss integrates z by Monte Carlo
    (``mc_samples`` shared draws)."""
    tables = planted_tables(cfg, spec)
    d = synthetic_criteo(num_rows, cfg, spec, start_row)
    gids = d["ids"].astype(np.int64) + tables["offsets"][None, :]
    id_logit = spec.bias + tables["effects"][gids].sum(axis=1)
    if spec.interaction_rank and spec.interaction_scale:
        id_logit += _pairwise_term(tables["latents"], gids)
    zrng = np.random.default_rng([spec.seed, 424242])
    z = np.log1p(np.exp(zrng.normal(
        size=(mc_samples, len(cfg.cont_boundaries))))) @ tables["w_dense"]
    return {"auc": roc_auc(d["label"], id_logit),
            "logloss": _mc_logloss(id_logit, z, d["label"], chunk)}


def linear_bayes_metrics(num_rows: int, cfg: CriteoConfig = CriteoConfig(),
                         spec: SyntheticSpec = SyntheticSpec(),
                         start_row: int = 0, mc_samples: int = 8192,
                         chunk: int = 65536) -> dict[str, float]:
    """AUC and logloss ceiling of an additive id model (one weight per
    (field, id), no dense input: the wide model's class) on the same
    slice.

    The planted logit is additive in the ids but for the pairwise term S.
    Its best additive L2 approximation under the independent per-field
    marginals (`zipf_marginals`) is

        S_add = c0 + Σ_f <U_f[id_f] − μ_f, M − μ_f>,
        μ_f = E[U_f[id_f]],  M = Σ_g μ_g,  c0 = Σ_{f<g} <μ_f, μ_g>.

    The oracle scores the planted logit with S replaced by S_add and the
    dense term dropped (the AUC); its logloss stays calibrated by
    integrating what it cannot see, the residual S − S_add (drawn from an
    independent slice) plus z = w·dense, by Monte Carlo. A chunk of rows
    takes a [chunk, min(mc_samples, 8192)] float64 matrix (4.3 GB at the
    defaults)."""
    tables = planted_tables(cfg, spec)
    field_vocabs = cfg.field_vocab_sizes
    d = synthetic_criteo(num_rows, cfg, spec, start_row)
    gids = d["ids"].astype(np.int64) + tables["offsets"][None, :]
    g = spec.bias + tables["effects"][gids].sum(axis=1)

    res_rows = min(mc_samples, 8192)
    if spec.interaction_rank and spec.interaction_scale:
        k = spec.interaction_rank
        mus = np.zeros((len(field_vocabs), k))
        for f, vocab in enumerate(field_vocabs):
            lo = tables["offsets"][f]
            mus[f] = zipf_marginals(vocab) @ tables["latents"][
                lo:lo + vocab].astype(np.float64)
        M = mus.sum(axis=0)
        c0 = 0.5 * (M @ M - np.einsum("fk,fk->", mus, mus))
        rows = tables["latents"][gids].astype(np.float64)    # [N, F, k]
        g += c0 + np.einsum("nfk,fk->n", rows - mus[None], M[None] - mus)

        # residual draws from an independent slice (only the ids matter)
        dres = synthetic_criteo(res_rows, cfg, spec,
                                start_row=start_row + num_rows + 1_000_003)
        rg = dres["ids"].astype(np.int64) + tables["offsets"][None, :]
        rrows = tables["latents"][rg].astype(np.float64)
        rs = c0 + np.einsum("nfk,fk->n", rrows - mus[None], M[None] - mus)
        r = _pairwise_term(tables["latents"], rg) - rs       # [mc]
    else:
        r = np.zeros(res_rows)

    # the dense term: independent noise to a model without dense input
    zrng = np.random.default_rng([spec.seed, 515151])
    z = np.log1p(np.exp(zrng.normal(
        size=(res_rows, len(cfg.cont_boundaries))))) @ tables["w_dense"]
    return {"auc": roc_auc(d["label"], g),
            "logloss": _mc_logloss(g, r + z, d["label"], chunk)}
