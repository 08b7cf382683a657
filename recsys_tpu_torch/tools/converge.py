"""The convergence-quality protocol on the card (counterpart of
``recsys_tpu/tools/converge.py``): train the Criteo zoo to the planted
task's ceilings.

    python -m recsys_tpu_torch.tools.converge [--device=cuda] \
        [--models=wide,wide_ftrl,fm,deepfm,dcn,xdeepfm,dnn] \
        [--examples=200000000] [--batch=16384] [--lr=...] \
        [--eval_rows=1048576] [--dropout=0.0] [--out=CONVERGENCE_torch.md]

Protocol, per model (the JAX package's):

- one-pass online training on FRESH rows of the planted distribution,
  drawn on the card every step inside the step's CUDA graph
  (`synthetic_device.make_device_sampler`,
  `fast.make_scanned_train_step_sampler`): no epoch reuse, the target is
  the population risk;
- Adam with a linear warm-up and a cosine decay to 0 over the example
  budget (``wide_ftrl``: FTRL-proximal at alpha ``PEAK_LR``, no schedule);
  the step count rounds up to a multiple of 200, the JAX run's steps per
  call, so both runs see the same number of examples;
- dropout 0 by default; full width (39 fields, 840,646 rows, dim 16);
- each model starts from the JAX package's initial weights of seed 0
  (`models.jax_init`), as its run started (`tools/converge_study.py`
  reads FM's result from other starting draws);
- eval on a held-out host-generated slice (start row 10⁹) against three
  ceilings computed on the host: linear (additive models), id-only
  (models that read only the ids) and Bayes (the true probabilities,
  reachable only by xDeepFM, whose linear branch reads the dense values).

The first call of each model captures the step's graph (its warm-up step
is a real step); it is timed apart (``capture_seconds``) and stays out of
``train_examples_per_s``. ``--device`` is ``cuda`` (the default; it fails
without a card and never falls back) or ``cpu``. Writes ``--out`` (by
default ``CONVERGENCE_torch.md``) and the ``.json`` beside it; every rate
there names the card and its power limit.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

log = logging.getLogger("recsys_tpu_torch.converge")

#: ``wide`` trains with Adam (the row that shows an additive model pinned
#: at the linear ceiling); ``wide_ftrl`` is the same model under its native
#: FTRL-proximal, on batch-mean gradients
DEFAULT_MODELS = ("wide", "wide_ftrl", "fm", "deepfm", "dcn", "xdeepfm",
                  "dnn")
EVAL_START_ROW = 1_000_000_000   # disjoint from every other slice
STEPS_PER_CALL = 200             # the JAX run's K: the budget rounds to it

#: peak lr at batch 16384 (the JAX package's, swept on its protocol);
#: wide_ftrl: the FTRL alpha
PEAK_LR = {"fm": 6e-3, "deepfm": 6e-3, "dcn": 6e-3, "xdeepfm": 6e-3,
           "dnn": 6e-3, "wide": 6e-3, "wide_ftrl": 4.0}

#: attainable ceiling of each hypothesis class
SEES_DENSE = ("xdeepfm",)
ADDITIVE = ("wide", "wide_ftrl")


def total_steps(examples: int, batch: int) -> int:
    """The step count of an example budget, rounded up to a multiple of
    `STEPS_PER_CALL` as the JAX run rounds it."""
    k = STEPS_PER_CALL
    return -(-examples // (batch * k)) * k


def ceilings(eval_rows: int, start_row: int = EVAL_START_ROW) -> dict:
    """The three ceilings on the eval slice (host numpy)."""
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.data import synthetic_device as sd

    return {
        "bayes_ceiling": criteo.synthetic_bayes_metrics(
            eval_rows, start_row=start_row),
        "idonly_ceiling": sd.idonly_bayes_metrics(eval_rows,
                                                  start_row=start_row),
        "linear_ceiling": sd.linear_bayes_metrics(eval_rows,
                                                  start_row=start_row),
    }


def initial_state(model, model_cfg, criteo_cfg, opt, seed: int, device):
    """(TrainState, optimizer) of ``model`` on ``device`` from the JAX
    package's initial weights of ``seed`` (`models.jax_init`): the weights
    its run of the protocol starts from. The run's generator (the
    sampler's draws) is the port's."""
    import torch

    from recsys_tpu_torch import convert
    from recsys_tpu_torch.models import jax_init
    from recsys_tpu_torch.train import train_state as TS

    params, state = jax_init.init_params(model.name, criteo_cfg, model_cfg,
                                         seed)
    params = convert.convert_params(params, device)
    return TS.TrainState(
        params, convert.convert_params(state, device), opt.init(params),
        torch.zeros((), dtype=torch.int32, device=device),
        TS.make_generator(seed + 1, device), seed), opt


def train(name: str, *, examples: int, batch: int, device,
          lr: float | None = None, dropout: float = 0.0, seed: int = 0,
          start=initial_state, log_every_calls: int = 20):
    """Train ``name`` on ``examples`` fresh rows drawn on ``device`` (cosine
    decay to 0), from ``start(model, model_cfg, criteo_cfg, opt, seed,
    device) -> (TrainState, optimizer)`` → (model, trained state, the
    run's numbers)."""
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import synthetic_device as sd
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import optim

    use_ftrl = name == "wide_ftrl"
    model_name = "wide" if use_ftrl else name
    criteo_cfg = CriteoConfig()
    model_cfg = ModelConfig(name=model_name, dropout=dropout)
    model = make_model(model_name, criteo_cfg, model_cfg)
    steps = total_steps(examples, batch)
    peak = lr if lr is not None else PEAK_LR.get(name, 3e-3)
    warmup = max(200, steps // 50)
    if use_ftrl:
        opt = optim.ftrl(alpha=peak, l1=0.0, l2=0.0)
        warmup = 0
    else:
        opt = optim.adam(optim.cosine_decay(peak, steps,
                                            warmup_steps=warmup))
    ts, tx = start(model, model_cfg, criteo_cfg, opt, seed, device)

    tables = sd.device_tables(sd.planted_tables(criteo_cfg), device)
    step_fn = fast.make_scanned_train_step_sampler(
        model, tx, sd.make_device_sampler(criteo_cfg), batch)

    # the first call is one step: the capture and its warm-up. A host
    # read of the loss waits for the card.
    tc = time.perf_counter()
    ts, loss = step_fn(ts, tables, 1, 0)
    float(loss)
    capture_s = time.perf_counter() - tc
    done, calls = 1, 0
    t0 = time.perf_counter()
    while done < steps:
        k = min(STEPS_PER_CALL, steps - done)
        ts, loss = step_fn(ts, tables, k, done)
        done += k
        calls += 1
        if calls % log_every_calls == 0:
            dt = time.perf_counter() - t0
            log.info("%s step %d/%d loss %.5f  %.0f ex/s", name, done,
                     steps, float(loss), (done - 1) * batch / dt)
    final_loss = float(loss)
    train_dt = time.perf_counter() - t0
    rate = (done - 1) * batch / train_dt if done > 1 else float("nan")
    return model, ts, {
        "examples": done * batch, "batch": batch, "peak_lr": peak,
        "warmup_steps": warmup, "dropout": dropout,
        "final_loss": final_loss, "train_seconds": train_dt,
        "capture_seconds": capture_s, "train_examples_per_s": rate,
    }


def evaluate(model, ts, eval_data: dict, batch: int, device) -> dict:
    """{'auc', 'logloss'} of ``ts`` on ``eval_data``, in batches of
    ``batch`` (the rows past the last whole batch are left out)."""
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import metrics as M

    rows = len(eval_data["label"])
    ebs = min(batch, rows)
    n_eb = rows // ebs
    eval_idx = np.arange(n_eb * ebs).reshape(n_eb, ebs)
    mstate = fast.make_scanned_eval(model)(
        ts.params, ts.model_state, fast.stage_dataset(eval_data, device),
        eval_idx, M.init_binary_metrics(device=device))
    return M.finalize_binary_metrics(mstate)


def converge_ctr(name: str, *, examples: int, batch: int, device,
                 lr: float | None = None, dropout: float = 0.0,
                 eval_rows: int = 1 << 20, seed: int = 0,
                 log_every_calls: int = 20,
                 eval_data: dict | None = None) -> dict:
    """`train` ``name`` from the JAX package's initial weights of ``seed``
    → its eval quality and the protocol's numbers."""
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo

    model, ts, run = train(name, examples=examples, batch=batch,
                           device=device, lr=lr, dropout=dropout, seed=seed,
                           log_every_calls=log_every_calls)
    if eval_data is None:
        eval_data = criteo.synthetic_criteo(eval_rows, CriteoConfig(),
                                            start_row=EVAL_START_ROW)
    quality = evaluate(model, ts, eval_data, batch, device)
    out = {"model": name, "auc": quality["auc"],
           "logloss": quality["logloss"], **run, "eval_rows": eval_rows}
    log.info("%s FINAL: auc %.4f logloss %.4f (%.1f s, %.0f ex/s)", name,
             quality["auc"], quality["logloss"], run["train_seconds"],
             run["train_examples_per_s"])
    return out


def score(rows: list[dict], ceil: dict) -> None:
    """Each row gains its class's ``ceiling``, ``gap_auc`` and ``closure``
    = (trained − linear) / (full − linear): the share of the interaction
    gap it recovers."""
    full, linear = ceil["bayes_ceiling"], ceil["linear_ceiling"]
    gap = max(full["auc"] - linear["auc"], 1e-9)
    for r in rows:
        if r["model"] in SEES_DENSE:
            which, c = "bayes", full
        elif r["model"] in ADDITIVE:
            which, c = "linear", linear
        else:
            which, c = "id-only", ceil["idonly_ceiling"]
        r["ceiling"] = which
        r["gap_auc"] = c["auc"] - r["auc"]
        r["gap_logloss"] = r["logloss"] - c["logloss"]
        r["closure"] = (r["auc"] - linear["auc"]) / gap


def render(result: dict) -> str:
    """The markdown report of a `main` result."""
    full = result["bayes_ceiling"]
    ido = result["idonly_ceiling"]
    lin = result["linear_ceiling"]
    card = result["card"]
    lines = [
        "# CONVERGENCE (PyTorch port) — trained quality against the "
        "planted ceilings",
        "",
        "Generated by `python -m recsys_tpu_torch.tools.converge` "
        + (f"at commit `{result['commit']}` " if result["commit"] != "unknown"
           else "")
        + f"on **{card}** ({result['generated']}).",
        "",
        f"Protocol: one-pass online training on **{result['examples']:,} "
        "fresh rows** of the planted second-order synthetic-Criteo "
        "distribution (`data/criteo.py` `SyntheticSpec`), drawn on the "
        "device every step inside the step's CUDA graph "
        "(`data/synthetic_device.py`, "
        "`fast.make_scanned_train_step_sampler`), batch "
        f"{result['batch']}, Adam with a linear warm-up and a cosine decay "
        f"to 0 (wide_ftrl: FTRL), dropout {result['dropout']}, from the "
        "JAX package's initial weights of seed 0 (`models/jax_init.py`). "
        "Eval on a "
        f"held-out {result['eval_rows']:,}-row slice (start row "
        f"{result['eval_start_row']:,}). The JAX package's run of the same "
        "protocol is `CONVERGENCE.md`.",
        "",
        "Three ceilings on this slice (host numpy, exact AUC):",
        "",
        f"- **linear (additive)**: AUC {lin['auc']:.4f} / logloss "
        f"{lin['logloss']:.4f}: the best per-(field, id) additive model "
        "(wide's class);",
        f"- **id-only**: AUC {ido['auc']:.4f} / logloss "
        f"{ido['logloss']:.4f}: E[y | ids], the best for fm, deepfm, dcn "
        "and dnn;",
        f"- **Bayes (full)**: AUC {full['auc']:.4f} / logloss "
        f"{full['logloss']:.4f}: the true probabilities (xdeepfm reads the "
        "dense values).",
        "",
        f"Interaction gap (full − linear) = {full['auc'] - lin['auc']:.4f} "
        "AUC; closure = (trained − linear) / (full − linear).",
        "",
        f"| model | AUC | logloss | ceiling | gap (AUC) | gap (logloss) | "
        f"closure | peak lr | ex/s on {card} | train s | capture s |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in result["models"]:
        lines.append(
            f"| {r['model']} | {r['auc']:.4f} | {r['logloss']:.4f} "
            f"| {r['ceiling']} | {r['gap_auc']:+.4f} "
            f"| {r['gap_logloss']:+.4f} | {r['closure']:+.0%} "
            f"| {r['peak_lr']:g} | {r['train_examples_per_s']:,.0f} "
            f"| {r['train_seconds']:.1f} | {r['capture_seconds']:.1f} |")
    lines += [
        "",
        "Gap (AUC) = the class's ceiling − trained AUC; gap (logloss) = "
        "trained − ceiling. The ceilings took "
        f"{result['ceiling_seconds']:.1f} s on the host.",
        "",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a.lstrip("-").split("=", 1) for a in argv if "=" in a)
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.tools.train_ctr import device_from_flag
    from recsys_tpu_torch.utils.profiling import card

    device = device_from_flag(kv.get("device", "cuda"))
    models = tuple(kv.get("models", ",".join(DEFAULT_MODELS)).split(","))
    examples = int(float(kv.get("examples", 2e8)))
    batch = int(kv.get("batch", 16384))
    lr = float(kv["lr"]) if "lr" in kv else None
    dropout = float(kv.get("dropout", 0.0))
    eval_rows = int(float(kv.get("eval_rows", 1 << 20)))
    out_path = kv.get("out", "CONVERGENCE_torch.md")
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True).stdout.strip()
    except OSError:
        commit = ""

    log.info("generating the %d-row eval slice and its ceilings ...",
             eval_rows)
    eval_data = criteo.synthetic_criteo(eval_rows, CriteoConfig(),
                                        start_row=EVAL_START_ROW)
    tc = time.perf_counter()
    ceil = ceilings(eval_rows)
    ceiling_s = time.perf_counter() - tc
    log.info("bayes auc %.4f | id-only auc %.4f | linear auc %.4f",
             ceil["bayes_ceiling"]["auc"], ceil["idonly_ceiling"]["auc"],
             ceil["linear_ceiling"]["auc"])

    rows = [converge_ctr(name, examples=examples, batch=batch, device=device,
                         lr=lr, dropout=dropout, eval_rows=eval_rows,
                         eval_data=eval_data)
            for name in models]
    score(rows, ceil)
    result = {
        "commit": commit or "unknown", "card": card(device),
        "device": device.type,
        "generated": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
        "examples": examples, "batch": batch, "dropout": dropout,
        "init": "jax",
        "eval_rows": eval_rows, "eval_start_row": EVAL_START_ROW,
        "ceiling_seconds": ceiling_s, **ceil, "models": rows,
    }
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(result, f, indent=1)
    with open(out_path, "w") as f:
        f.write(render(result))
    log.info("wrote %s", out_path)
    return result


if __name__ == "__main__":
    main()
