"""The input pipeline's throughput from a raw TSV to the training step, by
stage (counterpart of ``recsys_tpu/tools/bench_stream.py``).

    python -m recsys_tpu_torch.tools.bench_stream [--device=cuda] \
        [--rows=2000000] [--batch=16384] [--train_steps=400] \
        [--workdir=./stream_bench] [--out=STREAMING_torch.md]

  s0  the synthetic raw-Criteo TSV writer               (rows/s, disk)
  s1  ``preprocess_tsv``: parse, impute, log, bucket,
      hash, shard (the native parser where it builds)   (rows/s)
  s2  ``ShardSource`` alone on the host                 (rows/s)
  s3  ``ShardSource`` through ``loader.device_prefetch``
      to the device, no step behind it                  (rows/s, MB/s)
  s4  streaming training: ``ShardSource`` →
      ``device_prefetch`` → the host-fed step
      (``fast.make_fed_train_step``, one CUDA-graph
      replay a step on the card), as ``train_ctr train
      --streaming`` runs it                              (examples/s)
  ref the devgen fast path on the same model and batch
      (the dataset on the device, one replay a step)    (examples/s)

Full-width DeepFM (dim 16, 100-100, Adam lr 3e-3). s4 is timed after one
epoch of warm-up (the capture, and the shard cache filled), ref after its
first call. s2 and s3 are `pipeline_rates`, which ``chip_smoke.py`` also
reads. ``--device`` is ``cuda`` (the default; without a card it fails) or
``cpu``. Writes ``--out`` and the ``.json`` beside it, the rates beside
the device's name (on the card its power limit too).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

log = logging.getLogger("recsys_tpu_torch.bench_stream")
K = 50                          # devgen steps per call


def pipeline_rates(src, device, batches: int) -> dict:
    """Rows/s of the input pipeline with no training step behind it, over
    ``batches`` batches after one (``src``'s shards already cached):
    ``ShardSource`` alone on the host (``shard_source``), and through
    ``device_prefetch`` to ``device`` with the last copy waited for
    (``device_prefetch``); ``batch_bytes``: the bytes of one batch."""
    import torch

    from recsys_tpu_torch.data.loader import device_prefetch

    rates = {}
    for name in ("shard_source", "device_prefetch"):
        it = iter(src) if name == "shard_source" else device_prefetch(
            iter(src), device)
        first = next(it)
        if name == "shard_source":
            rates["batch_bytes"] = sum(v.nbytes for v in first.values())
        rows = len(first["label"]) * batches
        t0 = time.perf_counter()
        for _ in range(batches):
            batch = next(it)
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        rates[name] = rows / (time.perf_counter() - t0)
        it.close()
        del batch, first
    return rates


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a.lstrip("-").split("=", 1) for a in argv if "=" in a)
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import criteo, native
    from recsys_tpu_torch.data.loader import ShardSource, device_prefetch
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.tools.train_ctr import device_from_flag
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS
    from recsys_tpu_torch.utils.profiling import card

    device = device_from_flag(kv.get("device", "cuda"))
    rows = int(float(kv.get("rows", 2e6)))
    batch = int(kv.get("batch", 16384))
    train_steps = int(kv.get("train_steps", 400))
    workdir = kv.get("workdir", "./stream_bench")
    out_path = kv.get("out", "STREAMING_torch.md")
    os.makedirs(workdir, exist_ok=True)
    cfg = CriteoConfig()
    result: dict = {"rows": rows, "batch": batch, "device": device.type,
                    "device_label": card(device)}

    # s0: the raw TSV
    tsv = os.path.join(workdir, "day_synth.tsv")
    t0 = time.perf_counter()
    criteo.write_synthetic_tsv(tsv, rows)
    result["s0_tsv_write_rows_per_s"] = rows / (time.perf_counter() - t0)

    # s1: the offline preprocess (the native parser where it builds)
    result["native_parser"] = native.available()
    t0 = time.perf_counter()
    paths = criteo.preprocess_tsv(tsv, os.path.join(workdir, "shards"), cfg,
                                  rows_per_shard=200_000)
    result["s1_preprocess_rows_per_s"] = rows / (time.perf_counter() - t0)
    log.info("s1: %d rows -> %d shards at %.0f rows/s", rows, len(paths),
             result["s1_preprocess_rows_per_s"])

    # s2, s3: the pipeline alone, over one pass of the rows after a warm
    # one (the shards cached)
    src = ShardSource(paths, batch, seed=0, num_epochs=-1)
    n_batches = max(1, rows // batch)
    it = iter(src)
    for _ in range(n_batches):
        next(it)
    it.close()
    pipe = pipeline_rates(src, device, n_batches)
    result["s2_host_pipeline_rows_per_s"] = pipe["shard_source"]
    result["s3_h2d_rows_per_s"] = pipe["device_prefetch"]
    result["s3_h2d_mb_per_s"] = (pipe["device_prefetch"] / batch
                                 * pipe["batch_bytes"] / 1e6)
    log.info("s2: %.0f rows/s; s3: %.0f rows/s (%.0f MB/s)",
             pipe["shard_source"], pipe["device_prefetch"],
             result["s3_h2d_mb_per_s"])

    # s4: the graphed host-fed step, timed after an epoch of warm-up
    model = make_model("deepfm", cfg, ModelConfig(embedding_dim=16,
                                                  deep_layers=(100, 100)))
    ts, tx = TS.create_train_state(model, 0, 3e-3, device)
    step = fast.make_fed_train_step(model, tx)
    batches = device_prefetch(iter(ShardSource(paths, batch, seed=1,
                                               num_epochs=-1)), device)
    warm = max(2, n_batches)
    for i in range(warm):
        loss = step(ts, next(batches), i)
    float(loss)
    t0 = time.perf_counter()
    for i in range(train_steps):
        loss = step(ts, next(batches), warm + i)
    float(loss)                            # waits for the last step
    s4 = train_steps * batch / (time.perf_counter() - t0)
    batches.close()
    result["s4_stream_train_examples_per_s"] = s4
    log.info("s4: streaming training %.0f ex/s over %d steps", s4,
             train_steps)
    del ts, step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ref: the devgen fast path on the same model and batch
    ts, tx = TS.create_train_state(model, 0, 3e-3, device)
    data = criteo.synthetic_criteo(max(4 * batch, 65536), cfg)
    staged = fast.stage_dataset(data, device)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(data["label"]), batch)
    ts, loss = step_fn(ts, staged, K, 0)         # the capture
    float(loss)
    calls = 4
    t0 = time.perf_counter()
    for c in range(calls):
        ts, loss = step_fn(ts, staged, K, K * (c + 1))
    float(loss)
    ref = calls * K * batch / (time.perf_counter() - t0)
    result["devgen_examples_per_s"] = ref
    result["stream_vs_devgen"] = s4 / ref
    log.info("devgen %.0f ex/s: streaming reaches %.0f%% of it", ref,
             100 * s4 / ref)

    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True).stdout.strip()
    except OSError:
        commit = ""
    result["commit"] = commit or "unknown"
    with open(os.path.splitext(out_path)[0] + ".json", "w") as f:
        json.dump(result, f, indent=1)
    with open(out_path, "w") as f:
        f.write(render(result))
    log.info("wrote %s", out_path)
    return result


def render(result: dict) -> str:
    """The markdown report of a `main` result."""
    r = result
    label = r["device_label"]
    return "\n".join([
        "# STREAMING (PyTorch port) — input-pipeline throughput, TSV to "
        "the training step",
        "",
        "Generated by `python -m recsys_tpu_torch.tools.bench_stream` at "
        f"commit `{r['commit']}` on **{label}**: {r['rows']:,} rows, batch "
        f"{r['batch']}, native parser {r['native_parser']}. The JAX "
        "package's run is `STREAMING.md`.",
        "",
        "The sustained streaming rate (s4) is capped by the slowest of s2 "
        "(the host pipeline) and s3 (the host-to-device path); the devgen "
        "row is the same training step with the dataset on the device.",
        "",
        "| stage | what | rate |",
        "|---|---|---|",
        f"| s0 | synthetic raw TSV writer (host) | "
        f"{r['s0_tsv_write_rows_per_s']:,.0f} rows/s |",
        f"| s1 | `preprocess_tsv` (parse, impute, log, bucket, hash, "
        f"shard; native={r['native_parser']}; host) | "
        f"{r['s1_preprocess_rows_per_s']:,.0f} rows/s |",
        f"| s2 | `ShardSource` alone (host) | "
        f"{r['s2_host_pipeline_rows_per_s']:,.0f} rows/s |",
        f"| s3 | through `device_prefetch` to {label} | "
        f"{r['s3_h2d_rows_per_s']:,.0f} rows/s "
        f"({r['s3_h2d_mb_per_s']:,.1f} MB/s) |",
        f"| s4 | **streaming training** (`ShardSource` → `device_prefetch` "
        f"→ the graphed host-fed step) on {label} | "
        f"**{r['s4_stream_train_examples_per_s']:,.0f} ex/s** |",
        f"| ref | devgen fast path (the dataset on the device) on {label} | "
        f"{r['devgen_examples_per_s']:,.0f} ex/s |",
        "",
        f"Streaming sustains **{100 * r['stream_vs_devgen']:.0f}%** of the "
        "devgen rate.",
        "",
    ])


if __name__ == "__main__":
    main()
