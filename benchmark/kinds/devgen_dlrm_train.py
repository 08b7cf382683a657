"""DLRM training cells: graphed K-step calls of the port's
``make_scanned_train_step_devgen`` with its ``dlrm_dcnv2`` model, over a
multi-hot set held on the card (`dlrm_data`), the batch indices drawn on the
card. The other training kinds step for step, with DLRM's data, weights,
optimizer readings and reference:

1. Set-up makes the set and the weights on the card from the seed and
   hands the weights to the port, which trains them in place (so the card
   holds the table once); it builds the port's model, train state and
   graphed K-step call (`port_dlrm`, `port`) and drives the train state
   through its first three steps by that call, one step a call, reading
   the losses, the first gradient's norms from Adagrad's accumulators after
   one step (a row's accumulator is then mean(g²), an element's g²) and
   the change of the weights after three, against the weights drawn again
   from the seed; then one whole call, so that every shape the window uses
   is built and captured.
2. The window: K-step calls for ``seconds`` of the host's clock, then one
   synchronise; ``train_examples_per_s`` is every example trained over the
   whole window. The bags' counts are read before and after it
   (`port_dlrm.bag_counts`). Traced, one more call runs under
   ``torch.profiler`` (`trace`).
3. The port's state is freed and the plain reference
   (``benchmark/models/dlrm.py`` ``train_steps``) follows the same three
   steps from the weights drawn again; ``compare.gaps`` judges the
   program's readings against the cell's limits, the leaves grouped as the
   table, the bottom MLP, the cross stack and the top MLP
   (``models.dlrm.GROUPS``).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare, dlrm_data, draws, port, port_dlrm, trace
from benchmark.models import criteo, dlrm

#: steps that the reference follows
CHECKED_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weights(config: dict, seed: int, device) -> dict:
    """The weights of ``seed``, the same at every call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.stream_seed(seed, "weights"))
    return dlrm.make_weights(config, gen, device)


def first_grad_norms(acc, config: dict) -> dict[str, float]:
    """{leaf path: the norm of its first gradient} from Adagrad's
    accumulators after one step from 0: ‖g‖² is D·Σ a over the table's
    rows and Σ a over a dense leaf's elements."""
    d = config["embedding_dim"]
    return {criteo.path_name(p): math.sqrt(
                float(a.double().sum()) * (d if p == ("table",) else 1))
            for p, a in criteo.paths(acc)}


def prepare(cell: dict, seed: int, device) -> dict:
    """Set-up: the set and weights of ``seed``, the port's train state and
    K-step call, and the program's readings of its first three steps,
    taken through that call one step a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell["config"], cell["traffic"]
    if device.type == "cuda":
        port_dlrm.build_kernels()
    dataset = dlrm_data.make_dataset(config, traffic, seed, device)
    model = port_dlrm.model(config)
    ts, tx = port_dlrm.train_state(model, config,
                                   weights(config, seed, device), seed,
                                   device)
    steps = port.step_fn(model, tx, dataset["label"].shape[0],
                         traffic["batch"])
    prog = {"losses": []}
    for s in range(CHECKED_STEPS):
        ts, loss = steps(ts, dataset, 1, s)
        prog["losses"].append(float(loss))
        if s == 0:
            prog["grad"] = dlrm.named(first_grad_norms(ts.opt_state.acc,
                                                       config))
    start = weights(config, seed, device)
    prog["change"] = dlrm.named(dlrm.change_norms(ts.params, start))
    del start
    return {"dataset": dataset, "model": model, "ts": ts, "steps": steps,
            "prog": prog}


def reference_readings(cell: dict, seed: int, state: dict,
                       **options) -> dict:
    """The reference's readings of the three steps from the weights of
    ``seed`` drawn again and the set of ``state`` (`prepare`);
    ``options``: ``train_steps``'s precision, or a fault planted in the
    reference."""
    config, dataset = cell["config"], state["dataset"]
    device = dataset["ids"].device
    if device.type == "cuda":
        # a float64 table takes twice a float32 one's blocks: hand back
        # what an earlier reading cached
        gc.collect()
        torch.cuda.empty_cache()
    result = dlrm.train_steps(config, cell["traffic"],
                              weights(config, seed, device), dataset, seed,
                              CHECKED_STEPS, **options)
    return {"losses": result["losses"], "grad": dlrm.named(result["grad0"]),
            "change": dlrm.named(result["change"])}


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """The cell from set-up to verdict → {'end_to_end': {metric: value},
    'attempted', 'failed', 'memory_peak_bytes', 'summary' (the traced
    call's, or None), 'ok', 'checks'}. ``t_start``: the host clock's
    reading at the process's start, for ``setup_s``."""
    config, traffic = cell["config"], cell["traffic"]
    k, batch = traffic["steps_per_call"], traffic["batch"]
    state = prepare(cell, seed, device)
    ts, steps, dataset = state.pop("ts"), state.pop("steps"), state["dataset"]
    model = state.pop("model")
    done = CHECKED_STEPS
    ts, loss = steps(ts, dataset, k, done)      # builds every shape
    done += k
    float(loss)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    counts_before = port_dlrm.bag_counts(model, device)

    # -- the window --------------------------------------------------------
    means = []
    t0 = time.perf_counter()
    while True:
        ts, loss = steps(ts, dataset, k, done)
        done += k
        means.append(loss)
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    attempted = k * len(means)
    rate = attempted * batch / (time.perf_counter() - t0)
    failed = k * int((~torch.isfinite(torch.stack(means))).sum())
    counts_after = port_dlrm.bag_counts(model, device)

    summary = None
    if traced:
        holder = {"ts": ts, "done": done}

        def call():
            holder["ts"], _ = steps(holder["ts"], dataset, k, holder["done"])
            holder["done"] += k

        summary = trace.profile(call, k)
        summary.update(examples_per_s=rate,
                       flops_per_example=dlrm.forward_flops(config), work={})
        if counts_before is not None and counts_after is not None:
            counts = {name: counts_after[name] - counts_before[name]
                      for name in counts_after}
            summary["bag_counts"] = counts
            summary["work"]["embedding"] = dlrm.embedding_work(
                config, traffic, counts["ids"] / attempted,
                counts["unique"] / attempted)
        del holder, call
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the port's state and its graph's memory go before the reference runs
    del ts, steps, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok, checks = compare.verdict(
        compare.gaps(state["prog"], reference_readings(cell, seed, state)),
        cell["limits"])
    return {"end_to_end": {"train_examples_per_s": rate, "setup_s": setup_s},
            "attempted": attempted, "failed": failed,
            "memory_peak_bytes": peak, "summary": summary, "ok": ok,
            "checks": checks}
