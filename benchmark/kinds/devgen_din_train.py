"""DIN training cells: graphed K-step calls of the port's
``make_scanned_train_step_devgen`` with its ``din`` model, over a set of
MovieLens-20M's shape held on the card (`din_data`), the batch indices drawn
on the card. The Criteo cells' kind (`devgen_train`) step for step, with
DIN's data, weights, reference and comparison groups:

1. Set-up makes the set and the weights on the card from the seed, builds
   the port's model, train state and graphed K-step call (`port_din`,
   `port`) and drives the train state through its first three steps by
   that call, one step a call, reading the losses, Adam's first moments
   after one step and the change of the weights after three; then one
   whole call, so that every shape the window uses is built and captured.
2. The window: K-step calls for ``seconds`` of the host's clock, then one
   synchronise; ``train_examples_per_s`` is every example trained over the
   whole window. The attention's counts are read before and after it
   (`port_din.attention_counts`). Traced, one more call runs under
   ``torch.profiler`` (`trace`).
3. The port's state is freed and the plain reference
   (``benchmark/models/din.py`` ``train_steps``) follows the same three
   steps; ``compare.gaps`` judges the program's readings against the
   cell's limits, the leaves grouped as tables, attention units and the
   MLP on top (``models.din.GROUPS``).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, din_data, draws, port, port_din, trace
from benchmark.models import criteo, din

#: steps that the reference follows
CHECKED_STEPS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(cell: dict, seed: int, device) -> dict:
    """Set-up: the set and weights of ``seed``, the port's train state and
    K-step call, and the program's readings of its first three steps,
    taken through that call one step a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell["config"], cell["traffic"]
    if device.type == "cuda":
        port.build_kernels()
    dataset = din_data.make_dataset(config, traffic, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.stream_seed(seed, "weights"))
    weights = criteo.make_weights(din.spec(config), gen, device)
    model = port_din.model(config)
    template, state_template = port.templates(model)
    params = din.pack(config, weights, template)
    start = din.pack(config, weights, template)
    ts, tx = port.train_state(model, config, params,
                              port.model_state(state_template, device), seed,
                              device)
    steps = port.step_fn(model, tx, dataset["label"].shape[0],
                         traffic["batch"])
    prog = {"losses": []}
    for s in range(CHECKED_STEPS):
        ts, loss = steps(ts, dataset, 1, s)
        prog["losses"].append(float(loss))
        if s == 0:
            b1 = config["optimizer"]["b1"]
            prog["grad"] = {name: norm / (1.0 - b1) for name, norm in
                            din.leaf_norms(ts.opt_state.mu).items()}
    prog["change"] = din.leaf_norms(compare.tree_sub(ts.params, start))
    return {"dataset": dataset, "weights": weights, "template": template,
            "model": model, "ts": ts, "steps": steps, "prog": prog}


def reference_readings(cell: dict, seed: int, state: dict,
                       **options) -> dict:
    """The reference's readings of the three steps from the weights and
    set of ``state`` (`prepare`); ``options``: ``train_steps``'s precision,
    or a fault planted in the reference."""
    config = cell["config"]
    result = din.train_steps(config, cell["traffic"], state["weights"],
                             state["dataset"], seed, CHECKED_STEPS,
                             **options)
    template = state["template"]
    return {"losses": result["losses"],
            "grad": din.leaf_norms(din.pack(config, result["grad0"],
                                            template)),
            "change": din.leaf_norms(din.pack(
                config, compare.tree_sub(result["params"],
                                         state["weights"]), template))}


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
    counts_before = port_din.attention_counts(model, device)

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
    counts_after = port_din.attention_counts(model, device)

    summary = None
    if traced:
        holder = {"ts": ts, "done": done}

        def call():
            holder["ts"], _ = steps(holder["ts"], dataset, k, holder["done"])
            holder["done"] += k

        summary = trace.profile(call, k)
        summary.update(examples_per_s=rate,
                       flops_per_example=din.forward_flops(config),
                       work=din.kernel_work(config, traffic))
        if counts_before is not None and counts_after is not None:
            summary["attention_counts"] = {
                name: counts_after[name] - counts_before[name]
                for name in counts_after}
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
