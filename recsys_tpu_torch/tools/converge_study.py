"""Two readings of the convergence protocol's outcome beside
`tools/converge.py`'s run (``CONVERGENCE_torch.json``):

    python -m recsys_tpu_torch.tools.converge_study [--device=cuda] \
        [--study=fm,cin] [--seeds=0,1,2,3] [--cin=kernels,plain] \
        [--examples=4e8] [--batch=16384] [--eval_rows=1048576] \
        [--ceilings=CONVERGENCE_torch.json] \
        [--out=CONVERGENCE_study_torch.json]

- ``fm``: FM's result under the protocol from several starting draws:
  the JAX package's initial weights of each seed of ``--seeds``
  (`models.jax_init`, the protocol's start) and the port's own draw of
  the same seed (`train_state.create_train_state`). Both runs of a seed
  draw the same rows (the sampler's stream is the seed's). Each run gets
  its AUC and its closure against the ceilings.
- ``cin``: first each CIN layer's kernels (K3f forward, K3b backward)
  against its plain version, both held to float64, at the protocol's
  shape (B = ``--batch``). Then xDeepFM under the protocol from the JAX
  run's weights of each seed, through the kernels and with the plain
  PyTorch CIN (`cin_kernel.cin_layer_reference` under autograd) in their
  place, as ``--cin`` lists them (both runs of a seed draw the same
  rows). Each run is scored on the eval slice and on the slice with its
  dense values permuted across rows: a model that reads the dense values
  loses AUC there. Beside it, the share of eval rows whose linear branch
  (``relu(dense @ w + b + Σ wide)``, the only reader of the dense values)
  is live at the start, from the dense term alone (the wide weights start
  within ±√(6 / V) of 0).

The ceilings are read from ``--ceilings`` (a `tools/converge.py` result
on the same eval slice; it raises if the slice differs). Each run prints
one JSON line as it ends; ``--out`` gets them all.
"""

from __future__ import annotations

import contextlib
import json
import logging
import sys
from unittest import mock

import numpy as np

from recsys_tpu_torch.tools import converge

def port_draw(model, model_cfg, criteo_cfg, opt, seed, device):
    """`converge.train`'s ``start`` from the port's own initial draw."""
    from recsys_tpu_torch.train import train_state as TS

    return TS.create_train_state(model, seed, 0.0, device, opt=opt)


@contextlib.contextmanager
def plain_cin():
    """Inside: every CIN layer is the plain PyTorch version under autograd,
    on any device (the kernels are not launched)."""
    from recsys_tpu_torch.ops import cin_kernel

    with mock.patch.object(cin_kernel, "cin_layer",
                           cin_kernel.cin_layer_reference):
        yield


def closure(auc: float, ceil: dict) -> float:
    lin = ceil["linear_ceiling"]["auc"]
    return (auc - lin) / (ceil["bayes_ceiling"]["auc"] - lin)


def permuted_dense(eval_data: dict, seed: int = 0) -> dict:
    """``eval_data`` with its dense rows permuted (ids and labels kept)."""
    perm = np.random.default_rng(seed).permutation(len(eval_data["label"]))
    return dict(eval_data, dense=eval_data["dense"][perm])


def start_lin_dense(seed: int) -> dict:
    """xDeepFM's ``lin_dense`` {'w': [13, 1], 'b': [1]} in the JAX run's
    initial weights of ``seed`` (numpy)."""
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.models import jax_init

    return jax_init.init_params("xdeepfm", CriteoConfig(),
                                ModelConfig(name="xdeepfm"),
                                seed)[0]["lin_dense"]


def run(name: str, ceil: dict, eval_data: dict, *, examples: int,
        batch: int, device, seed: int, start, label: str) -> dict:
    """One protocol run of ``name`` → its JSON record (printed); xDeepFM's
    also holds its AUC with the dense values permuted and the live share
    of its linear branch at the start."""
    from recsys_tpu_torch.ops import cuda_build

    with cuda_build.counting() as launches:
        model, ts, info = converge.train(name, examples=examples,
                                         batch=batch, device=device,
                                         seed=seed, start=start)
        q = converge.evaluate(model, ts, eval_data, batch, device)
    rec = {"model": name, "start": label, "seed": seed, "auc": q["auc"],
           "logloss": q["logloss"], "closure": closure(q["auc"], ceil),
           "cin_kernel_launches": [launches["cin_fwd"],
                                   launches["cin_bwd"]], **info}
    if name == "xdeepfm":
        lin = start_lin_dense(seed)
        rec["dense_live_at_start"] = float(
            (eval_data["dense"] @ lin["w"][:, 0] + lin["b"][0] > 0).mean())
        rec["auc_dense_permuted"] = converge.evaluate(
            model, ts, permuted_dense(eval_data), batch, device)["auc"]
    print(json.dumps(rec), flush=True)
    return rec


def cin_at_protocol_shape(batch: int, device, seed: int = 0) -> list:
    """Each CIN layer's kernels (K3f, K3b) at the protocol's shape (N =
    ``batch`` · 16 rows, F0 = 39, the layers' Fk and H) on random inputs,
    against the plain version in float32 and in float64: the largest
    |kernel − float64| and |plain − float64| of the forward's output and of
    each backward output. The backward takes the plain forward's y, so
    that all three see one ReLU mask."""
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.ops import cin_kernel

    ccfg, mcfg = CriteoConfig(), ModelConfig(name="xdeepfm")
    gen = torch.Generator().manual_seed(seed)
    n, f0 = batch * mcfg.embedding_dim, len(ccfg.field_vocab_sizes)
    layers, fk = [], f0
    for h in mcfg.cin_layers:
        lim = (6.0 / (f0 * fk + h)) ** 0.5
        x0v = torch.randn(n, f0, generator=gen).to(device)
        xkv = torch.randn(n, fk, generator=gen).to(device)
        w = torch.empty(f0 * fk, h).uniform_(-lim, lim,
                                             generator=gen).to(device)
        b = (0.1 * torch.randn(h, generator=gen)).to(device)
        dy = torch.randn(n, h, generator=gen).to(device)
        y = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
        f64 = [t.double() for t in (x0v, xkv, w, b, y, dy)]
        kern = (cin_kernel.cin_layer_fwd(x0v, xkv, w, b),
                *cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy))
        plain = (y, *cin_kernel.cin_layer_backward_reference(x0v, xkv, w, y,
                                                             dy))
        ref = (cin_kernel.cin_layer_reference(*f64[:4]),
               *cin_kernel.cin_layer_backward_reference(*f64[:3], *f64[4:]))
        rec: dict = {"n": n, "f0": f0, "fk": fk, "h": h}
        for name, k, p, r in zip(("y", "dx0", "dxk", "dw", "db"), kern,
                                 plain, ref):
            rec[name] = {"kernel_vs_f64": float((k.double() - r).abs().max()),
                         "plain_vs_f64": float((p.double() - r).abs().max()),
                         "max_abs": float(r.abs().max())}
        layers.append(rec)
        fk = h
    return layers


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a.lstrip("-").split("=", 1) for a in argv if "=" in a)
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.tools.train_ctr import device_from_flag
    from recsys_tpu_torch.utils.profiling import card

    device = device_from_flag(kv.get("device", "cuda"))
    studies = kv.get("study", "fm,cin").split(",")
    seeds = [int(s) for s in kv.get("seeds", "0,1,2,3").split(",")]
    examples = int(float(kv.get("examples", 4e8)))
    batch = int(kv.get("batch", 16384))
    eval_rows = int(float(kv.get("eval_rows", 1 << 20)))
    with open(kv.get("ceilings", "CONVERGENCE_torch.json")) as fh:
        ceil = json.load(fh)
    if (ceil["eval_rows"], ceil["eval_start_row"]) != (
            eval_rows, converge.EVAL_START_ROW):
        raise ValueError(
            f"the ceilings are of {ceil['eval_rows']} rows at "
            f"{ceil['eval_start_row']}, the eval slice {eval_rows} at "
            f"{converge.EVAL_START_ROW}")
    eval_data = criteo.synthetic_criteo(eval_rows, CriteoConfig(),
                                        start_row=converge.EVAL_START_ROW)
    common = {"examples": examples, "batch": batch, "device": device}
    result: dict = {"card": card(device), "examples": examples,
                    "batch": batch, "eval_rows": eval_rows, "runs": []}
    for study in studies:
        if study == "fm":
            for seed in seeds:
                for label, start in (("jax", converge.initial_state),
                                     ("port", port_draw)):
                    result["runs"].append(run(
                        "fm", ceil, eval_data, seed=seed, start=start,
                        label=label, **common))
        elif study == "cin":
            result["cin_at_protocol_shape"] = cin_at_protocol_shape(batch,
                                                                    device)
            print(json.dumps({"cin_at_protocol_shape":
                              result["cin_at_protocol_shape"]}), flush=True)
            variants = {"kernels": ("jax, CIN kernels",
                                    contextlib.nullcontext),
                        "plain": ("jax, plain CIN", plain_cin)}
            runs = [(seed, *variants[v]) for seed in seeds
                    for v in kv.get("cin", "kernels,plain").split(",")]
            for seed, label, ctx in runs:
                with ctx():
                    result["runs"].append(run(
                        "xdeepfm", ceil, eval_data, seed=seed,
                        start=converge.initial_state, label=label,
                        **common))
        else:
            raise ValueError(f"--study={study}: want fm or cin")
    with open(kv.get("out", "CONVERGENCE_study_torch.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
