"""The results tables of the port (counterpart of
``recsys_tpu/tools/results.py``): every model family measured on one
device, written to ``--out`` (by default ``RESULTS_torch.md``) and the
``.json`` beside it.

    python -m recsys_tpu_torch.tools.results [--device=cuda] \
        [--out=RESULTS_torch.md] [--batch=16384] [--rows=8388608] \
        [--steps=rows/batch] [--lr=2e-3] [--models=fm,deepfm,...] \
        [--ctr=1] [--din=1] [--cf=1] [--serving=1] [--workdir=...]

- CTR zoo: quality (AUC, logloss on the planted synthetic task: a
  regression target, not comparable to real Criteo) after ONE epoch over
  ``--rows`` distinct rows, training and eval ex/s, beside the id-only and
  Bayes ceilings of the eval slice. Training runs the fast path's devgen
  K-step call (one CUDA-graph replay a step on the card), eval the graphed
  eval call; the first call (the capture) is not timed;
- DIN on planted taste-cluster sequences (the same devgen call);
- the CF family (the VAE-CF trainer, CDAE), ranking metrics;
- serving: a briefly trained full-width DeepFM served on the device over
  REST, and its saturation throughput (4 client threads keep batches of
  8192 in flight, each call one graph replay); then ``train_ctr serve
  --device=cpu`` in a process of its own, the CPU latency mode (REST,
  gRPC where ``grpcio`` imports, the socket front end, the NumPy engine),
  for the Criteo and the u_id/i_id demo DeepFM, and the NumPy engine in
  process (one BLAS thread where ``threadpoolctl`` imports; the row says
  whether it did).

``--device`` is ``cuda`` (the default; without a card it fails, it never
falls back) or ``cpu``. Every rate in the report names the device it ran
on (on the card its name and power limit). A partial rerun (``--models=``
a subset, or a section off) merges into the existing ``.json``: rows and
sections it does not measure are kept with the commit they were measured
at.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

log = logging.getLogger("recsys_tpu_torch.results")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the reference's throughput (examples/s on 2× GTX 1080 Ti, global_step/s
#: × 256, the JAX package's table)
REF_EXS = {"fm": 23 * 256, "deepfm": 12 * 256, "dcn": 45 * 256,
           "xdeepfm": 14 * 256, "dnn": 41 * 256, "din": 124 * 256}
CTR_MODELS = ("fm", "deepfm", "dcn", "xdeepfm", "dnn", "wide")
#: per-model lr of the 1-epoch protocol: wide's FTRL alpha works on
#: batch-mean gradients (the JAX package's value)
CTR_LR = {"wide": 4.0}
K = 50                           # steps per call

#: the DIN and CF sections' data and epochs (the JAX package's)
DIN_DATA = dict(n_users=20_000, item_vocab=2000, cate_vocab=40)
CF_DATA = dict(n_users=1200, n_items=400, n_heldout_users=150)
CF_EPOCHS, CDAE_EPOCHS = 25, 40
#: the serving section's sizes: DeepFM's training before export, the
#: served-AUC rows, the saturation run and the latency loops
SERVE_TRAIN_ROWS = 1 << 22
SERVE_TRAIN_STEPS = 1500
SERVE_AUC_ROWS = 25_600
SATURATION = dict(batch=8192, clients=4, reqs=16)
LATENCY_ITERS = 50


def bench_ctr(name: str, *, batch: int, steps: int, rows: int, device,
              synth, lr: float = 1e-3, seed: int = 0) -> dict:
    """Train a Criteo-zoo model on the planted synthetic rows for ``steps``
    steps (one epoch by default) → quality and steady-state throughput."""
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import metrics as M
    from recsys_tpu_torch.train import train_state as TS

    cfg = CriteoConfig()
    model = make_model(name, cfg, ModelConfig(name=name))
    lr = CTR_LR.get(name, lr)
    ts, tx = TS.create_train_state(model, seed, lr, device)
    eval_rows = max(8 * batch, 65536)
    staged = fast.stage_dataset(synth(rows), device)
    staged_eval = fast.stage_dataset(synth(eval_rows, 10 * rows), device)
    step_fn = fast.make_scanned_train_step_devgen(model, tx, rows, batch)
    eval_fn = fast.make_scanned_eval(model)

    ts, loss = step_fn(ts, staged, K, 0)        # the capture: not timed
    float(loss)
    calls = max(1, -(-max(steps - K, K) // K))
    t0 = time.perf_counter()
    for c in range(calls):
        ts, loss = step_fn(ts, staged, K, K * (c + 1))
    float(loss)                                 # waits for the last step
    train_exs = calls * K * batch / (time.perf_counter() - t0)

    ebs = min(batch, eval_rows)
    n_batches = eval_rows // ebs
    idx = np.arange(n_batches * ebs).reshape(n_batches, ebs)

    def evaluate():
        return eval_fn(ts.params, ts.model_state, staged_eval, idx,
                       M.init_binary_metrics(device=device))

    quality = M.finalize_binary_metrics(evaluate())   # and the capture
    t0 = time.perf_counter()
    float(evaluate().count)
    eval_exs = n_batches * ebs / (time.perf_counter() - t0)
    del staged, staged_eval
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"model": name, "auc": quality["auc"],
           "logloss": quality["logloss"], "train_examples_per_s": train_exs,
           "eval_examples_per_s": eval_exs, "batch": batch,
           "steps": (calls + 1) * K}
    if name in REF_EXS:
        out["vs_reference"] = train_exs / REF_EXS[name]
    log.info("%s: auc %.4f logloss %.4f  %.0f train ex/s  %.0f eval ex/s",
             name, out["auc"], out["logloss"], train_exs, eval_exs)
    return out


def bench_din(*, device, batch: int = 1024, steps: int = 300,
              seed: int = 0) -> dict:
    """DIN on planted taste-cluster sequences (the hardened task: noisy
    histories and in-category negatives)."""
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.data import amazon
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import metrics as M
    from recsys_tpu_torch.train import train_state as TS

    ds = amazon.synthetic_din_hard(**DIN_DATA, seed=seed)
    model = make_model("din", ds.item_vocab, ds.cate_vocab,
                       ModelConfig(name="din", embedding_dim=16,
                                   dropout=0.1, use_bn=False))
    ts, tx = TS.create_train_state(model, seed, 3e-3, device)
    data = {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
            "hist_cate": ds.hist_cate, "label": ds.label}
    hold = max(4 * batch, len(ds.label) // 10)
    train = {k: v[:-hold] for k, v in data.items()}
    evald = {k: v[-hold:] for k, v in data.items()}
    staged = fast.stage_dataset(train, device)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(train["label"]), batch)

    ts, loss = step_fn(ts, staged, K, 0)        # the capture: not timed
    float(loss)
    calls = max(1, -(-max(steps - K, K) // K))
    t0 = time.perf_counter()
    for c in range(calls):
        ts, loss = step_fn(ts, staged, K, K * (c + 1))
    float(loss)
    train_exs = calls * K * batch / (time.perf_counter() - t0)

    eval_step = TS.make_eval_step(model)
    mstate = M.init_binary_metrics(device=device)
    for lo in range(0, len(evald["label"]) - batch + 1, batch):
        b = fast.stage_dataset({k: v[lo:lo + batch]
                                for k, v in evald.items()}, device)
        mstate = eval_step(ts.params, ts.model_state, mstate, b)
    quality = M.finalize_binary_metrics(mstate)
    out = {"model": "din", "auc": quality["auc"],
           "logloss": quality["logloss"], "train_examples_per_s": train_exs,
           "batch": batch, "vs_reference": train_exs / REF_EXS["din"]}
    log.info("din: auc %.4f  %.0f train ex/s", out["auc"], train_exs)
    return out


def bench_cf(*, device, seed: int = 0, workdir: str | None = None
             ) -> list[dict]:
    """The VAE-CF family through its trainer, and CDAE: ranking metrics on
    planted synthetic interactions (the protocol's; not ML-20M's values)."""
    from recsys_tpu_torch.data import movielens as ML
    from recsys_tpu_torch.models import cdae as CDAE
    from recsys_tpu_torch.train import metrics as M
    from recsys_tpu_torch.train.vae_loop import VaeTrainConfig, train_vae_cf

    workdir = workdir or tempfile.mkdtemp(prefix="recsys_results_")
    u, i, r = ML.synthetic_interactions(n_users=CF_DATA["n_users"],
                                        n_items=CF_DATA["n_items"], seed=seed)
    data = ML.preprocess_vae_cf(u, i, r,
                                n_heldout_users=CF_DATA["n_heldout_users"])
    rows = []
    for name in ("multi_vae", "multi_dae", "logistic_vae"):
        cfg = VaeTrainConfig(model=name, latent_dim=32, hidden_dim=128,
                             epochs=CF_EPOCHS, batch_size=250,
                             total_anneal_steps=2000,
                             model_dir=os.path.join(workdir, name))
        t0 = time.perf_counter()
        res = train_vae_cf(data, cfg, device=device)
        rows.append({
            "model": name, "best_val_ndcg@100": res["best_ndcg"],
            "test_ndcg@100": res["test"]["ndcg@100"],
            "test_recall@20": res["test"]["recall@20"],
            "test_recall@50": res["test"]["recall@50"],
            "train_seconds": time.perf_counter() - t0,
        })
        log.info("%s: %s", name, rows[-1])

    users, train_x, _, test_x = ML.synthetic_ml100k(n_users=400, n_items=200,
                                                    seed=seed)
    t0 = time.perf_counter()
    params, apply, _ = CDAE.train_cdae(train_x, users, hidden=32,
                                       epochs=CDAE_EPOCHS, batch_size=64,
                                       device=device)
    sr = {f"sr@{n}": M.success_rate_at_n(
        CDAE.predict_topn(apply, params, train_x, users, n=n), test_x)
        for n in (1, 5, 10)}
    rows.append({"model": "cdae", **sr,
                 "train_seconds": time.perf_counter() - t0})
    log.info("cdae: %s", rows[-1])
    return rows


def _saturation(sv, feats: dict, device_label: str) -> dict:
    """Saturation throughput of the servable on the device: ``clients``
    threads each send ``reqs`` predicts of ``batch`` rows straight to
    ``sv.predict`` (thread-safe; each call one graph replay on the card),
    so calls overlap as a batched ranking tier's would."""
    s = SATURATION
    sv.predict(feats)                        # the bucket's capture
    done = []

    def worker():
        for _ in range(s["reqs"]):
            done.append(len(sv.predict(feats)))

    threads = [threading.Thread(target=worker) for _ in range(s["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    exs = sum(done) / (time.perf_counter() - t0)
    log.info("serving throughput on %s: %.0f ex/s (%d clients x %d calls "
             "of %d rows)", device_label, exs, s["clients"], s["reqs"],
             s["batch"])
    return {"model": "deepfm-criteo", "device": device_label,
            "protocol": f"saturation ({s['clients']} clients)",
            "batch": s["batch"], "examples_per_s": exs}


def _grpc_available() -> bool:
    import importlib.util

    return importlib.util.find_spec("grpc") is not None


def _bench_cpu_serving(export_dir: str, model_tag: str, sample_fn,
                       auc_rows: int = 0, engine: str = "jit") -> list[dict]:
    """The CPU latency mode: ``train_ctr serve --device=cpu`` in a process
    of its own, p50 / p99 over REST (with the client's encoding), gRPC on
    a prepared body (where ``grpcio`` imports) and the socket front end
    (NPZ1 and RAW1 bodies), at batches 200 and 500; ``auc_rows`` > 0 adds
    the AUC of that many served rows (batches of 512 over the socket)."""
    from recsys_tpu_torch.serve import client as C
    from recsys_tpu_torch.serve.fastsock import SocketClient
    from recsys_tpu_torch.train.metrics import roc_auc

    tag = "" if engine == "jit" else f" ({engine})"
    proc = subprocess.Popen(
        [sys.executable, "-m", "recsys_tpu_torch.tools.train_ctr", "serve",
         f"--export_dir={export_dir}", "--port=0", "--device=cpu",
         f"--engine={engine}", "--buckets=200,256,500,512"],
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    port = None
    seen: list[str] = []
    try:
        for line in proc.stderr:     # "serving <m> on cpu ... REST:<port>"
            seen.append(line)
            if "serving" in line and "REST:" in line:
                port = int(line.rsplit("REST:", 1)[1].split()[0])
                break
        if port is None:
            raise RuntimeError("the CPU serve process ended before it "
                               "bound a port; its stderr:\n"
                               + "".join(seen[-15:]))
        threading.Thread(target=lambda: [None for _ in proc.stderr],
                         daemon=True).start()   # keep its pipe drained
        stub = C.make_grpc_stub(port + 1) if _grpc_available() else None
        rows = []
        row = {"device": "cpu", "model": model_tag}
        for n in (200, 500):
            data, _ = sample_fn(n)
            stats = C.benchmark_serving(
                lambda f: C.rest_predict(port, f), data, None, warmup=3,
                iters=LATENCY_ITERS)
            rows.append({**stats, **row, "batch": n,
                         "protocol": "rest+encode" + tag})
            body = C.prepare_body(data, "npz")
            if stub is not None:
                stats = C.benchmark_serving(
                    lambda _: C.grpc_send(stub, body), data, None, warmup=3,
                    iters=LATENCY_ITERS)
                rows.append({**stats, **row, "batch": n,
                             "protocol": "grpc prepared" + tag})
            sc = SocketClient(port + 2)
            stats = C.benchmark_serving(lambda _: sc.send(body), data, None,
                                        warmup=3, iters=LATENCY_ITERS)
            rows.append({**stats, **row, "batch": n,
                         "protocol": "socket npz" + tag})
            raw_body = C.prepare_body(data, "raw")
            stats = C.benchmark_serving(lambda _: sc.send(raw_body), data,
                                        None, warmup=5,
                                        iters=2 * LATENCY_ITERS)
            sc.close()
            rows.append({**stats, **row, "batch": n,
                         "protocol": "socket raw" + tag})
            log.info("cpu serving %s batch %d: %s", model_tag, n, rows[-1])
        if stub is None:
            rows.append({**row, "batch": 200,
                         "protocol": "grpc: not measured (grpcio does not "
                                     "import)"})
        if auc_rows:
            sc = SocketClient(port + 2)
            probs, ys = [], []
            for _ in range(auc_rows // 512):
                data, labels = sample_fn(512)
                probs.append(sc.send(C.prepare_body(data, "raw")))
                ys.append(labels)
            sc.close()
            auc = roc_auc(np.concatenate(ys), np.concatenate(probs))
            rows.append({**row, "batch": 512, "auc": auc,
                         "protocol": f"served-AUC ({auc_rows} rows)"})
            log.info("served AUC (%s, %d rows): %.4f", model_tag, auc_rows,
                     auc)
        return rows
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def bench_serving(*, device, device_label: str, synth, seed: int = 0,
                  workdir: str | None = None) -> list[dict]:
    """Serving at the reference's batch sizes (its CPU TF-Serving: 0.29 ms
    at 200, 0.36 ms at 500) and a served-AUC check, for the full Criteo
    DeepFM (briefly trained first, so that its served AUC means something)
    and the u_id/i_id demo DeepFM the reference's own latency test served;
    the device's REST rows and saturation throughput; the CPU latency
    mode."""
    import torch

    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data import criteo, demo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.serve import client as C
    from recsys_tpu_torch.serve.export import Servable, export_servable
    from recsys_tpu_torch.serve.server import make_rest_server
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    cfg = CriteoConfig()
    mcfg = ModelConfig(name="deepfm")
    model = make_model("deepfm", cfg, mcfg)
    workdir = workdir or tempfile.mkdtemp(prefix="recsys_results_")
    ts, tx = TS.create_train_state(model, seed, 2e-3, device)
    ts, _ = fast.train_on_device(
        model, tx, ts, synth(SERVE_TRAIN_ROWS), batch_size=8192,
        num_steps=SERVE_TRAIN_STEPS, steps_per_call=100)
    d = os.path.join(workdir, "export_deepfm")
    export_servable(d, "deepfm", ts.params, ts.model_state, mcfg, cfg)
    del ts
    sv = Servable(d, device=device.type,
                  buckets=(256, 512, SATURATION["batch"]))
    sv.warmup()
    server, batcher = make_rest_server(sv, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    rows = []
    try:
        for n in (200, 500):
            data = criteo.synthetic_criteo(n, cfg)
            data.pop("label")
            stats = C.benchmark_serving(
                lambda f: C.rest_predict(port, f), data, None, warmup=3,
                iters=20)
            rows.append({**stats, "batch": n, "model": "deepfm-criteo",
                         "device": device_label, "protocol": "rest+encode"})
            log.info("serving batch %d on %s: %s", n, device_label, stats)
        feats = criteo.synthetic_criteo(SATURATION["batch"], cfg,
                                        start_row=77_000_000)
        feats.pop("label")
        rows.append(_saturation(sv, feats, device_label))
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    del sv
    if device.type == "cuda":
        torch.cuda.empty_cache()

    next_row = [20_000_000]

    def criteo_sample(n):
        data = criteo.synthetic_criteo(n, cfg, start_row=next_row[0])
        next_row[0] += n
        return data, data.pop("label")

    rows += _bench_cpu_serving(d, "deepfm-criteo", criteo_sample,
                               auc_rows=SERVE_AUC_ROWS)
    rows += _bench_cpu_serving(d, "deepfm-criteo", criteo_sample,
                               engine="numpy")

    schema = demo.demo_schema()
    demo_model = make_model("deepfm", schema, mcfg)
    dparams, dstate = demo_model.init(torch.Generator().manual_seed(seed),
                                      "cpu")
    dd = os.path.join(workdir, "export_deepfm_demo")
    export_servable(dd, "deepfm", dparams, dstate, mcfg, schema)
    demo_seed = [seed]

    def demo_sample(n):
        demo_seed[0] += 1
        data = demo.synthetic_demo(n, seed=demo_seed[0], schema=schema)
        return data, data.pop("label")

    rows += _bench_cpu_serving(dd, "deepfm-demo", demo_sample)
    rows += _bench_cpu_serving(dd, "deepfm-demo", demo_sample,
                               engine="numpy")

    # in process, the NumPy engine without a transport: the compute's own
    # latency, on one BLAS thread where threadpoolctl can set it
    sv_np = Servable(dd, device="cpu", engine="numpy")
    try:
        from threadpoolctl import threadpool_limits
        limits, blas = threadpool_limits(limits=1), "1 BLAS thread"
    except ImportError:
        limits, blas = None, "BLAS threads not set: no threadpoolctl"
    try:
        for n in (200, 500):
            data, _ = demo_sample(n)
            stats = C.benchmark_serving(lambda f: sv_np.predict(f), data,
                                        None, warmup=20,
                                        iters=6 * LATENCY_ITERS)
            rows.append({**stats, "batch": n, "device": "cpu",
                         "model": "deepfm-demo",
                         "protocol": f"inproc predict (numpy; {blas})"})
            log.info("inproc numpy predict batch %d: %s", n, stats)
    finally:
        if limits is not None:
            limits.unregister()
    return rows


def _md_table(rows: list[dict], cols: list[tuple[str, str, str]]) -> str:
    head = "| " + " | ".join(t for t, _, _ in cols) + " |"
    sep = "|" + "|".join("---" for _ in cols) + "|"
    lines = [head, sep]
    for r in rows:
        cells = []
        for _, key, fmt in cols:
            v = r.get(key)
            cells.append("—" if v is None else format(v, fmt)
                         if fmt else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _flag(kv: dict, name: str) -> bool:
    return kv.get(name, "1") not in ("0", "false")


def render(result: dict) -> str:
    """The markdown report of a `main` result."""
    label = result["device_label"]
    md = [
        "# RESULTS (PyTorch port) — measured numbers",
        "",
        "Generated by `python -m recsys_tpu_torch.tools.results` at commit "
        f"`{result['commit']}` on **{label}** ({result['generated']}).",
        "",
        "Quality numbers are on the planted second-order synthetic task "
        "(fixed seeds; `data/criteo.py` `SyntheticSpec`): regression "
        "targets of this code, not comparable to the reference's "
        "real-dataset AUC. `(bayes ceiling)` scores the true probabilities "
        "of the eval slice; `(id-only ceiling)` is the best for models that "
        "never read the raw dense values (all but xDeepFM). The one-epoch "
        "rows are short; `CONVERGENCE_torch.md` runs the long protocol "
        "against three ceilings. `vs reference` divides the rate by the "
        "reference's 2-GPU examples/s (`BASELINE.md`). Rows merged from an "
        "earlier run keep their own `commit` (in the `.json`).",
        "",
        f"## CTR zoo (synthetic Criteo, 39 fields, emb 16, batch "
        f"{result['batch']}, ex/s on {label})",
        "",
        _md_table(result["ctr"] + [
            {"model": "(id-only ceiling)", **result["idonly_ceiling"]},
            {"model": "(bayes ceiling)", **result["bayes_ceiling"]}], [
            ("model", "model", ""), ("AUC", "auc", ".4f"),
            ("logloss", "logloss", ".4f"),
            ("train ex/s", "train_examples_per_s", ",.0f"),
            ("eval ex/s", "eval_examples_per_s", ",.0f"),
            ("vs reference", "vs_reference", ".1f"),
        ]),
    ]
    if "din" in result:
        md += ["", f"## DIN (synthetic taste-cluster sequences, ex/s on "
               f"{label})", "",
               _md_table([result["din"]], [
                   ("model", "model", ""), ("AUC", "auc", ".4f"),
                   ("logloss", "logloss", ".4f"),
                   ("train ex/s", "train_examples_per_s", ",.0f"),
                   ("batch", "batch", "d"),
                   ("vs reference", "vs_reference", ".1f"),
               ])]
    if "cf" in result:
        md += ["", f"## CF family (synthetic interactions, on {label})", "",
               _md_table([r for r in result["cf"] if r["model"] != "cdae"], [
                   ("model", "model", ""),
                   ("best val NDCG@100", "best_val_ndcg@100", ".4f"),
                   ("test NDCG@100", "test_ndcg@100", ".4f"),
                   ("test Recall@20", "test_recall@20", ".4f"),
                   ("test Recall@50", "test_recall@50", ".4f"),
                   ("train s", "train_seconds", ".1f"),
               ]),
               "",
               _md_table([r for r in result["cf"] if r["model"] == "cdae"], [
                   ("model", "model", ""), ("SR@1", "sr@1", ".2f"),
                   ("SR@5", "sr@5", ".2f"), ("SR@10", "sr@10", ".2f"),
                   ("train s", "train_seconds", ".1f"),
               ])]
    if "serving" in result:
        md += ["", "## Serving (the reference: 0.29 ms at 200 / 0.36 ms at "
               "500 on CPU TF-Serving, serving the 2-feature u_id/i_id demo "
               "DeepFM: the `deepfm-demo` rows)", "",
               f"Rows of device `{label}` are the served model on that "
               "device (REST with the client's encoding, and the saturation "
               "rate of concurrent calls); rows of device `cpu` are `train_ctr "
               "serve --device=cpu` on the same machine's host, one request "
               "at a time.", "",
               _md_table(result["serving"], [
                   ("model", "model", ""), ("device", "device", ""),
                   ("protocol", "protocol", ""), ("batch", "batch", "d"),
                   ("p50 ms", "latency_ms_p50", ".3f"),
                   ("p99 ms", "latency_ms_p99", ".3f"),
                   ("mean ms", "latency_ms_mean", ".3f"),
                   ("ex/s", "examples_per_s", ",.0f"),
                   ("AUC", "auc", ".4f"),
               ])]
    md.append("")
    return "\n".join(md)


def main(argv: list[str] | None = None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    argv = argv if argv is not None else sys.argv[1:]
    kv = dict(a[2:].split("=", 1) for a in argv
              if a.startswith("--") and "=" in a)
    from recsys_tpu_torch.core.config import CriteoConfig
    from recsys_tpu_torch.data import criteo
    from recsys_tpu_torch.data.synthetic_device import idonly_bayes_metrics
    from recsys_tpu_torch.tools.train_ctr import device_from_flag
    from recsys_tpu_torch.utils.profiling import card

    device = device_from_flag(kv.get("device", "cuda"))
    label = card(device)
    batch = int(kv.get("batch", 16384))
    rows_n = int(kv.get("rows", 8_388_608))
    steps = int(kv.get("steps", max(1, rows_n // batch)))   # one epoch
    lr = float(kv.get("lr", 2e-3))
    models = kv.get("models", ",".join(CTR_MODELS)).split(",")
    out_path = kv.get("out", "RESULTS_torch.md")
    workdir = kv.get("workdir") or tempfile.mkdtemp(prefix="recsys_results_")
    try:
        commit = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True).stdout.strip()
    except OSError:
        commit = ""
    commit = commit or "unknown"

    cfg = CriteoConfig()
    cache: dict = {}

    def synth(rows: int, start_row: int = 0) -> dict:
        """Synthetic rows, made once for every model that trains on them."""
        if (rows, start_row) not in cache:
            cache[(rows, start_row)] = criteo.synthetic_criteo(
                rows, cfg, start_row=start_row)
        return cache[(rows, start_row)]

    json_path = os.path.splitext(out_path)[0] + ".json"
    old: dict = {}
    if os.path.exists(json_path):
        with open(json_path) as f:
            old = json.load(f)
    eval_rows = max(8 * batch, 65536)
    result: dict = {
        "device": device.type, "device_label": label, "commit": commit,
        "generated": time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime()),
        "batch": batch, "steps": steps,
        "idonly_ceiling": idonly_bayes_metrics(eval_rows,
                                               start_row=10 * rows_n),
        "bayes_ceiling": criteo.synthetic_bayes_metrics(
            eval_rows, start_row=10 * rows_n)}
    new_ctr = ([bench_ctr(m, batch=batch, steps=steps, rows=rows_n,
                          device=device, synth=synth, lr=lr)
                for m in models] if _flag(kv, "ctr") else [])
    for r in new_ctr:
        r.update(commit=commit, device_label=label)
    # rows carried over keep the commit (and device) they were measured at
    by_model = {r["model"]: dict(r, commit=r.get("commit",
                                                 old.get("commit", "?")))
                for r in old.get("ctr", [])}
    by_model.update({r["model"]: r for r in new_ctr})
    order = [m for m in CTR_MODELS if m in by_model]
    order += [m for m in by_model if m not in order]
    result["ctr"] = [by_model[m] for m in order]
    cache.clear()

    sections = {
        "din": lambda: bench_din(device=device, batch=min(batch, 1024),
                                 steps=min(steps, 300)),
        "cf": lambda: bench_cf(device=device, workdir=workdir),
        "serving": lambda: bench_serving(device=device, device_label=label,
                                         synth=synth, workdir=workdir),
    }
    for name, run in sections.items():
        if _flag(kv, name):
            result[name] = run()
        elif name in old:
            sec = old[name]
            result[name] = (dict(sec, merged_from=old.get("commit", "?"))
                            if isinstance(sec, dict) else sec)

    with open(out_path, "w") as f:
        f.write(render(result))
    with open(json_path, "w") as f:
        json.dump(result, f, indent=1)
    log.info("wrote %s and %s", out_path, json_path)
    return result


if __name__ == "__main__":
    main()
