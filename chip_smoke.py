#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``recsys_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA card and nvcc (CUDA_HOME or PATH)

It fails (exit code other than 0, no result line) without a CUDA device or
without the package beside it. On a card it

1. prints the card's name and power limit (nvidia-smi) and builds the three
   kernels from their sources, one nvcc each, all started together:
   ``csrc/cin_layer.cu`` (CIN forward), ``csrc/cin_backward.cu`` (CIN
   backward) and ``csrc/segment_sum.cu`` (the embedding-gradient sum);
2. kernel phases, each kernel against its plain PyTorch version on the card
   at the main paths' shapes, timed with CUDA events in the order plain,
   kernel, kernel, plain:
   - CIN forward and backward: the three layers of full-width xDeepFM at
     N = 16·B rows for B in 1, 200, 4096 and at a ragged N (forward
     tolerance 1e-4 absolute and relative: 1521-term float32 sums in
     another order than cuBLAS; backward the same for dx0/dxk, and for
     dW/db, sums over all N rows, 1e-4 relative plus 1e-4·N/1024
     absolute), timed at B = 4096;
   - segment sum: the big (837,632 rows) and small (4,096 rows) tables of
     DeepFM at batch 16384 with the engine's own ids, a ragged N, one id
     for every update, and N = 0 (tolerance 1e-5 of the row's Σ|g|: sums
     in another order), bitwise equal across two calls, timed at batch
     16384;
3. serving: full-width xDeepFM with seeded random weights, exported,
   served over REST from a thread at batches 1, 200 and 4096 (JSON, NPZ1,
   RAW1), every answer within 1e-4 of the CPU servable and 3 forward
   launches per request; then ``train_ctr serve --device=cuda`` from the
   command line answers one request;
4. training: full-width DeepFM at batch 16384 and full-width xDeepFM at
   batch 4096 through ``fast.make_scanned_train_step_devgen``, 200 steps in
   calls of K = 50 on a device-resident synthetic dataset. The loss must be
   finite and fall, each step must launch the segment sum twice (and, for
   xDeepFM, the CIN forward and backward three times each), the eval AUC on
   held-out rows must beat the untrained model's by 0.02, the CIN filters'
   gradients on the card must be non-zero, and 3 steps at dropout 0 on the
   card must match the same 3 steps on the CPU (plain versions) within
   1e-4 on every parameter (a tenth of one Adam step at lr 1e-3);
5. ``train_ctr train --device=cuda`` from the command line on synthetic
   shards exits 0, prints an eval AUC and leaves a checkpoint.

Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32 = False`` (and cuDNN's TF32 off).

The last two lines are one JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCHES = (1, 200, 4096)
RAGGED_N = 3333          # not a multiple of the kernels' row tiles
TOL = 1e-4
LATENCY_REQUESTS = 20
K = 50                   # steps per host call
TRAIN_STEPS = 200
AUC_MARGIN = 0.02
STEP_TOL = 1e-4


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def _cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _timed_pair(kern, plain, iters: int) -> tuple[float, float]:
    """(kernel ms, plain ms), in the order plain, kernel, kernel, plain."""
    t = [_cuda_ms(f, iters) for f in (plain, kern, kern, plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def _cin_inputs(gen, n, f0, fk, h, dev):
    lim = (6.0 / (f0 * fk + h)) ** 0.5
    x0v = torch.randn(n, f0, generator=gen).to(dev)
    xkv = torch.randn(n, fk, generator=gen).to(dev)
    w = torch.empty(f0 * fk, h).uniform_(-lim, lim, generator=gen).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    return x0v, xkv, w, b


def cin_forward_phase(cin_kernel, layers, dev) -> dict:
    """CIN forward kernel vs plain version: errors at every shape, times at
    B = 4096."""
    gen = torch.Generator().manual_seed(1234)
    max_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for n in [16 * b for b in BATCHES] + [RAGGED_N]:
        for f0, fk, h in layers:
            x0v, xkv, w, b = _cin_inputs(gen, n, f0, fk, h, dev)
            got = cin_kernel.cin_layer_fwd(x0v, xkv, w, b)
            ref = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= TOL + TOL * ref.abs()).all())
            max_abs = max(max_abs, err.max().item())
            ref64 = cin_kernel.cin_layer_reference(
                x0v.double(), xkv.double(), w.double(), b.double())
            line = (f"cin fwd N={n} F0={f0} Fk={fk} H={h}: max_abs_err="
                    f"{err.max().item():.3e}; vs f64: kernel "
                    f"{(got - ref64).abs().max().item():.3e} plain "
                    f"{(ref - ref64).abs().max().item():.3e}")
            if n == 16 * BATCHES[-1]:
                k_ms, p_ms = _timed_pair(
                    lambda: cin_kernel.cin_layer_fwd(x0v, xkv, w, b),
                    lambda: cin_kernel.cin_layer_reference(x0v, xkv, w, b),
                    50)
                ms += k_ms
                plain_ms += p_ms
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            print(line, flush=True)
            _check(ok, f"CIN forward kernel disagrees with its plain version "
                       f"at N={n} Fk={fk} H={h}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def cin_backward_phase(cin_kernel, layers, dev) -> dict:
    """CIN backward kernel vs plain version: errors at every shape, times
    at B = 4096."""
    gen = torch.Generator().manual_seed(4321)
    max_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for n in [16 * b for b in BATCHES] + [RAGGED_N]:
        for f0, fk, h in layers:
            x0v, xkv, w, b = _cin_inputs(gen, n, f0, fk, h, dev)
            y = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
            dy = torch.randn(n, h, generator=gen).to(dev)
            got = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
            ref = cin_kernel.cin_layer_backward_reference(x0v, xkv, w, y, dy)
            ref64 = cin_kernel.cin_layer_backward_reference(
                x0v.double(), xkv.double(), w.double(), y.double(),
                dy.double())
            torch.cuda.synchronize()
            line = f"cin bwd N={n} F0={f0} Fk={fk} H={h}:"
            for name, g, r, r64 in zip(("dx0", "dxk", "dw", "db"), got, ref,
                                       ref64):
                atol = TOL * (max(1.0, n / 1024) if name in ("dw", "db")
                              else 1.0)
                err = (g - r).abs()
                ok = bool(torch.isfinite(g).all()) and bool(
                    (err <= atol + TOL * r.abs()).all())
                max_abs = max(max_abs, err.max().item())
                line += (f" {name} err {err.max().item():.3e} (vs f64: kernel "
                         f"{(g - r64).abs().max().item():.3e} plain "
                         f"{(r - r64).abs().max().item():.3e});")
                _check(ok, f"CIN backward kernel disagrees with its plain "
                           f"version on {name} at N={n} Fk={fk} H={h}")
            again = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
            _check(all(torch.equal(a, g) for a, g in zip(again, got)),
                   f"CIN backward kernel not deterministic at N={n} Fk={fk}")
            if n == 16 * BATCHES[-1]:
                k_ms, p_ms = _timed_pair(
                    lambda: cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy),
                    lambda: cin_kernel.cin_layer_backward_reference(
                        x0v, xkv, w, y, dy), 20)
                ms += k_ms
                plain_ms += p_ms
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            print(line, flush=True)
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def segment_sum_phase(ss, ccfg, dev) -> dict:
    """Segment-sum kernel vs plain version on the card; times at batch
    16384 (the big and the small table together, sort included)."""
    from recsys_tpu_torch.core.config import EmbeddingConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.embeddings import engines

    eng = engines.SplitEngine(EmbeddingConfig(ccfg.field_vocab_sizes, 16))
    params = eng.init(torch.Generator().manual_seed(0), "meta")
    ids = torch.from_numpy(synthetic_criteo(16384, ccfg, start_row=555)[
        "ids"].astype(np.int64)).to(dev)
    gen = torch.Generator().manual_seed(99)
    cases = []   # (label, ids, grads, rows, timed)
    for name, _, fields, offsets in eng._index_tensors(dev):
        gids = (ids.index_select(1, fields) + offsets).reshape(-1)
        rows = params[name].shape[0]
        g = torch.randn(gids.shape[0], 17, generator=gen).to(dev)
        cases.append((f"{name} table B=16384", gids, g, rows, True))
    g = torch.randn(RAGGED_N, 17, generator=gen).to(dev)
    cases.append(("ragged", torch.randint(0, 1000, (RAGGED_N,),
                                          generator=gen).to(dev), g, 1000,
                  False))
    g = torch.randn(409_600, 17, generator=gen).to(dev)
    cases.append(("one id", torch.zeros(409_600, dtype=torch.int64,
                                        device=dev), g, 4096, False))
    cases.append(("N=0", torch.zeros(0, dtype=torch.int64, device=dev),
                  torch.zeros(0, 17, device=dev), 4096, False))

    max_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for label, gids, g, rows, timed in cases:
        got = ss.segment_sum(gids, g, rows)
        ref = ss.segment_sum_reference(gids, g, rows)
        scale = ss.segment_sum_reference(gids, g.abs(), rows)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 1e-5 * scale + 1e-6).all())
        max_abs = max(max_abs, err.max().item() if err.numel() else 0.0)
        same = torch.equal(got, ss.segment_sum(gids, g, rows))
        uniq = int(torch.unique(gids).numel())
        line = (f"segment sum {label}: N={gids.shape[0]} rows={rows} "
                f"unique={uniq} max_abs_err="
                f"{err.max().item() if err.numel() else 0.0:.3e} "
                f"bitwise_repeat={same}")
        if timed:
            k_ms, p_ms = _timed_pair(
                lambda: ss.segment_sum(gids, g, rows),
                lambda: ss.segment_sum_reference(gids, g, rows), 50)
            ms += k_ms
            plain_ms += p_ms
            line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
        print(line, flush=True)
        _check(ok, f"segment-sum kernel disagrees with its plain version "
                   f"({label})")
        _check(same, f"segment-sum kernel not bitwise deterministic "
                     f"({label})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def randomize(params, state, seed: int):
    """Every leaf replaced by seeded noise of its shape: BN var in [0.5, 2];
    the biases of the three one-unit branch outputs in [1, 2], so that
    their ReLUs stay alive; the rest is the initial value plus noise of
    0.3 times its spread (0.1 where the initial value is constant), so
    activations keep the scale of the initializers and the probabilities do
    not saturate. Without it fresh init leaves branches dead and answers
    0.5."""
    from recsys_tpu_torch.core import checkpoint, tree
    gen = torch.Generator().manual_seed(seed)
    alive = ("['lin_dense']['b']", "['cin_out']['b']", "['dnn_out']['b']")
    leaves = []
    for path, t in checkpoint.flatten([params, state]):
        if path.endswith("['var']"):
            new = torch.empty(t.shape).uniform_(0.5, 2.0, generator=gen)
        elif path.endswith(alive):
            new = torch.empty(t.shape).uniform_(1.0, 2.0, generator=gen)
        else:
            spread = t.std().item() if t.numel() > 1 else 0.0
            sigma = 0.3 * spread if spread > 0 else 0.1
            new = t + sigma * torch.randn(t.shape, generator=gen)
        leaves.append(new.to(t.dtype))
    return tree.fill_like([params, state], leaves)


def serving_phase(cin_kernel, export_dir: str, ccfg) -> dict:
    """REST serving on the card against the CPU servable; → p50 ms."""
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable
    from recsys_tpu_torch.serve.server import make_rest_server

    sv = Servable(export_dir, device="cuda")
    sv_cpu = Servable(export_dir, device="cpu")
    srv, batcher = make_rest_server(sv, 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    p50 = {}
    try:
        reqs = {}
        for i, b in enumerate(BATCHES):
            d = synthetic_criteo(b, ccfg, start_row=10_000 * i)
            feats = {"ids": d["ids"], "dense": d["dense"]}
            reqs[b] = (feats, sv_cpu.predict(feats))
            client.rest_send(port, client.prepare_body(feats, "raw"))  # warm
        cin_kernel.LAUNCHES = 0          # the serving path starts here
        n_req = 0
        for b, (feats, ref) in reqs.items():
            bodies = {fmt: client.prepare_body(feats, fmt)
                      for fmt in ("json", "npz", "raw")}
            lat = []
            for fmt in ["json", "npz"] + ["raw"] * LATENCY_REQUESTS:
                before = cin_kernel.LAUNCHES
                t0 = time.perf_counter()
                got = client.rest_send(port, bodies[fmt], "xdeepfm")
                dt = time.perf_counter() - t0
                n_req += 1
                if fmt == "raw":
                    lat.append(dt)
                _check(cin_kernel.LAUNCHES - before == 3,
                       f"batch {b} {fmt}: {cin_kernel.LAUNCHES - before} "
                       "kernel launches, want 3 (one per CIN layer)")
                _check(got.shape == (b,) and bool(np.isfinite(got).all()),
                       f"batch {b} {fmt}: answer shape {got.shape} or values")
                err = float(np.abs(got - ref).max())
                _check(err <= TOL, f"batch {b} {fmt}: |card - cpu| = {err}")
            p50[b] = float(np.percentile(lat, 50) * 1e3)
            print(f"served batch {b}: RAW1/JSON/NPZ1 within {TOL} of the CPU "
                  f"run; probs mean {ref.mean():.4f} std {ref.std():.4f}; "
                  f"p50 {p50[b]:.3f} ms p99 "
                  f"{np.percentile(lat, 99) * 1e3:.3f} ms over {len(lat)} "
                  "RAW1 requests", flush=True)
            _check(b == 1 or float(ref.std()) > 1e-3,
                   f"batch {b}: probabilities do not vary; the check is void")
        launches = cin_kernel.LAUNCHES   # the serving path ends here
        _check(launches == 3 * n_req,
               f"{launches} kernel launches for {n_req} requests")
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        thread.join(10)
    return {"launches": launches, "p50_ms": p50, "requests": n_req}


def _run_cli(args: list[str], timeout: float, until=None):
    """Run ``python -m recsys_tpu_torch.tools.train_ctr <args>``, echoing
    its output. With ``until`` (a function of one output line returning a
    value or None) the process is left running until a line gives a value,
    and (proc, value) is returned; without, it runs to its end and (exit
    code, output) is returned."""
    cmd = [sys.executable, "-m", "recsys_tpu_torch.tools.train_ctr"] + args
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()

    def drain():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.monotonic() + timeout
    out = []
    try:
        while True:
            _check(time.monotonic() < deadline,
                   f"{' '.join(cmd)} did not finish in {timeout} s")
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                proc.wait(30)
                _check(until is None, f"{' '.join(cmd)} exited with "
                                      f"{proc.returncode}")
                return proc.returncode, "".join(out)
            print("  cli: " + line.rstrip(), flush=True)
            out.append(line)
            value = until(line) if until is not None else None
            if value is not None:
                return proc, value
    except BaseException:
        _stop(proc)
        raise


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(20)


def serve_cli_phase(export_dir: str, ccfg) -> None:
    """The user's entry point: serve from the command line, one request."""
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable

    def port_of(line):
        m = re.search(r"REST:(\d+)", line)
        return int(m.group(1)) if m else None

    proc, port = _run_cli(["serve", f"--export_dir={export_dir}",
                           "--device=cuda", "--port=0"], 300, until=port_of)
    try:
        d = synthetic_criteo(200, ccfg, start_row=77)
        feats = {"ids": d["ids"], "dense": d["dense"]}
        got = client.rest_send(port, client.prepare_body(feats, "raw"))
        ref = Servable(export_dir, device="cpu").predict(feats)
        err = float(np.abs(got - ref).max())
        _check(err <= TOL, f"command-line server: |card - cpu| = {err}")
        print(f"command-line server on port {port}: batch 200 within {TOL} "
              "of the CPU run", flush=True)
    finally:
        _stop(proc)


def _cin_grads(name, ccfg, mcfg, data, batch_size, dev) -> list[float]:
    """The CIN filters' gradients for one batch at dropout 0, from seeded
    random weights that keep every branch alive (`randomize`), on the card
    and on the CPU; → max |grad| of each filter on the card, after checking
    that the two agree within 1e-4 of the largest gradient."""
    import dataclasses

    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import train_state as TS

    model = make_model(name, ccfg, dataclasses.replace(mcfg, dropout=0.0))
    params, state = randomize(*model.init(torch.Generator().manual_seed(3),
                                          "cpu"), seed=4)
    out = []
    for d in ("cpu", dev):
        batch = {k: torch.from_numpy(v[:batch_size]).to(d)
                 for k, v in data.items()}
        batch["ids"] = batch["ids"].long()
        on = lambda t: t.to(d)  # noqa: E731
        _, _, grads = TS.loss_and_grads(model, tree.tree_map(on, params),
                                        tree.tree_map(on, state), batch)
        out.append([layer["w"].cpu() for layer in grads["cin"]])
    for g_cpu, g_dev in zip(*out):
        err = float((g_dev - g_cpu).abs().max())
        _check(err <= 1e-4 * float(g_cpu.abs().max()),
               f"{name}: CIN filter gradient on the card differs from the CPU "
               f"by {err}")
    return [float(g.abs().max()) for g in out[1]]


def _eval_auc(model, ts, staged_eval, batch_size) -> float:
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import metrics as M

    n = next(iter(staged_eval.values())).shape[0]
    idx = np.arange(n // batch_size * batch_size).reshape(-1, batch_size)
    mstate = fast.make_scanned_eval(model)(
        ts.params, ts.model_state, staged_eval, idx,
        M.init_binary_metrics(device=ts.step.device))
    return M.finalize_binary_metrics(mstate)["auc"]


def _three_steps_match(name, ccfg, mcfg, data, batch_size, dev) -> float:
    """3 steps at dropout 0 from one state on one [3, B] index matrix, on the
    card and on the CPU; → max |Δ| over every parameter."""
    import dataclasses

    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    model = make_model(name, ccfg, dataclasses.replace(mcfg, dropout=0.0))
    idx = np.random.default_rng(7).integers(0, len(data["label"]),
                                            (3, batch_size))
    out = []
    for d in ("cpu", dev):
        ts, tx = TS.create_train_state(model, 11, 1e-3, d)
        ts, loss = fast.make_scanned_train_step(model, tx)(
            ts, fast.stage_dataset(data, d), idx)
        out.append((float(loss), tree.leaves(ts.params)))
    (l_cpu, p_cpu), (l_dev, p_dev) = out
    _check(abs(l_cpu - l_dev) <= 1e-5 * abs(l_cpu),
           f"{name}: 3-step loss card {l_dev} vs cpu {l_cpu}")
    diff = max(float((b.cpu() - a).abs().max()) for a, b in zip(p_cpu, p_dev))
    _check(diff <= STEP_TOL, f"{name}: params after 3 steps differ by {diff} "
                             f"between card and CPU (tolerance {STEP_TOL})")
    return diff


def train_phase(name, ccfg, mcfg, batch_size, dev, cin_kernel, ss) -> dict:
    """Train full-width ``name`` on the card through the devgen fast path;
    → counts and numbers of the main path's run."""
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    model = make_model(name, ccfg, mcfg)
    data = synthetic_criteo(16 * batch_size, ccfg)
    eval_data = synthetic_criteo(4 * batch_size, ccfg, start_row=10 ** 8)
    staged = fast.stage_dataset(data, dev)
    staged_eval = fast.stage_dataset(eval_data, dev)
    ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
    auc0 = _eval_auc(model, ts, staged_eval, batch_size)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(data["label"]), batch_size)

    torch.cuda.synchronize()
    ss.LAUNCHES = cin_kernel.LAUNCHES = cin_kernel.BWD_LAUNCHES = 0
    losses, t_calls = [], []
    for _ in range(TRAIN_STEPS // K):        # the training path starts here
        t0 = time.perf_counter()
        ts, loss = step_fn(ts, staged, K)
        losses.append(float(loss))           # one host read per call
        t_calls.append(time.perf_counter() - t0)
    counts = {"segment_sum": ss.LAUNCHES, "cin_fwd": cin_kernel.LAUNCHES,
              "cin_bwd": cin_kernel.BWD_LAUNCHES}   # ... and ends here
    steps = K * len(losses)
    # the first call warms up the allocator and cuBLAS: rate over the rest
    ex_s = batch_size * K * (len(t_calls) - 1) / sum(t_calls[1:])
    auc1 = _eval_auc(model, ts, staged_eval, batch_size)
    print(f"{name} training at batch {batch_size}: {steps} steps, mean loss "
          f"per call {['%.5f' % l for l in losses]}, eval AUC {auc0:.4f} -> "
          f"{auc1:.4f} on {len(eval_data['label'])} held-out rows, "
          f"{ex_s:.1f} ex/s (calls 2-{len(t_calls)}), launches {counts}",
          flush=True)
    _check(all(np.isfinite(losses)), f"{name}: loss {losses}")
    _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    _check(counts["segment_sum"] == 2 * steps,
           f"{name}: {counts['segment_sum']} segment-sum launches for "
           f"{steps} steps, want {2 * steps}")
    if name == "xdeepfm":
        _check(counts["cin_fwd"] == 3 * steps and
               counts["cin_bwd"] == 3 * steps,
               f"{name}: CIN launches {counts} for {steps} steps, want "
               f"{3 * steps} each")
        g = _cin_grads(name, ccfg, mcfg, data, batch_size, dev)
        print(f"{name}: max |grad| of the CIN filters on the card: {g} "
              "(within 1e-4 of the CPU's)", flush=True)
        _check(min(g) > 0, f"{name}: a CIN filter has no gradient: {g}")
    _check(auc1 >= auc0 + AUC_MARGIN,
           f"{name}: eval AUC {auc1} after training, {auc0} before")
    diff = _three_steps_match(name, ccfg, mcfg, data, batch_size, dev)
    print(f"{name}: 3 steps at dropout 0 on the card match the CPU: max "
          f"|param diff| {diff:.3e} (tolerance {STEP_TOL})", flush=True)
    return {"counts": counts, "ex_s": ex_s, "auc": (auc0, auc1),
            "losses": losses}


def train_cli_phase(ccfg) -> None:
    """``train_ctr train --device=cuda`` on synthetic shards."""
    from recsys_tpu_torch.data.criteo import write_synthetic_shards

    with tempfile.TemporaryDirectory() as tmp:
        data_dir, model_dir = f"{tmp}/data", f"{tmp}/model"
        write_synthetic_shards(data_dir, 10 * 32768, 10, ccfg)
        code, out = _run_cli(
            ["train", "--model.name=deepfm", "--device=cuda",
             f"--data_dir={data_dir}", f"--train.model_dir={model_dir}",
             "--train.batch_size=16384", "--train.num_steps=100",
             "--train.eval_every_steps=50", "--train.eval_steps=2"], 600)
        _check(code == 0, f"train_ctr train exited with {code}")
        m = re.search(r"'auc': ([0-9.]+)", out)
        _check(m is not None, "train_ctr train printed no eval AUC")
        ckpts = sorted(os.listdir(model_dir))
        _check("step_100" in ckpts, f"no checkpoint step_100 in {ckpts}")
        print(f"command-line training: eval AUC {m.group(1)}, checkpoints "
              f"{ckpts}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.ops import cin_kernel, cuda_build
    from recsys_tpu_torch.ops import segment_sum as ss
    from recsys_tpu_torch.serve.export import export_servable

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)   # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    sources = [cin_kernel.SOURCE, cin_kernel.BWD_SOURCE, ss.SOURCE]
    libs = cuda_build.build_all(sources)
    print(f"built {len(libs)} kernels in parallel in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    for lib in libs:
        with open(lib + ".log") as f:
            spills = [l.strip() for l in f if "spill" in l and
                      " 0 bytes spill " not in l]
        print(f"{os.path.relpath(lib, ROOT)} ptxas spills: "
              + ("; ".join(spills) if spills else "none"), flush=True)

    ccfg = CriteoConfig()
    f0 = len(ccfg.field_vocab_sizes)
    xcfg = ModelConfig(name="xdeepfm")
    # (F0, Fk, H) of each CIN layer: 39 fields, then each layer's width
    fks = (f0,) + tuple(xcfg.cin_layers[:-1])
    layers = [(f0, fk, h) for fk, h in zip(fks, xcfg.cin_layers)]
    fwd = cin_forward_phase(cin_kernel, layers, dev)
    bwd = cin_backward_phase(cin_kernel, layers, dev)
    seg = segment_sum_phase(ss, ccfg, dev)
    print(f"kernel phases ok [{card}]: CIN fwd {fwd['ms']:.4f} ms vs plain "
          f"{fwd['plain_ms']:.4f} ms, CIN bwd {bwd['ms']:.4f} ms vs plain "
          f"{bwd['plain_ms']:.4f} ms (three layers at B=4096); segment sum "
          f"{seg['ms']:.4f} ms vs plain {seg['plain_ms']:.4f} ms (both "
          "tables at B=16384)", flush=True)

    model = make_model("xdeepfm", ccfg, xcfg)
    params, state = randomize(*model.init(torch.Generator().manual_seed(0),
                                          "cpu"), seed=1)
    with tempfile.TemporaryDirectory() as export_dir:
        export_servable(export_dir, "xdeepfm", params, state, xcfg, ccfg)
        served = serving_phase(cin_kernel, export_dir, ccfg)
        serve_cli_phase(export_dir, ccfg)
    print("served p50 latency (REST, RAW1, one request at a time): "
          + ", ".join(f"batch {b}: {ms:.3f} ms"
                      for b, ms in served["p50_ms"].items())
          + f" [{card}]", flush=True)

    deepfm = train_phase("deepfm", ccfg, ModelConfig(name="deepfm"), 16384,
                         dev, cin_kernel, ss)
    xdeepfm = train_phase("xdeepfm", ccfg, xcfg, 4096, dev, cin_kernel, ss)
    print(f"training throughput [{card}]: DeepFM B=16384 "
          f"{deepfm['ex_s']:.1f} ex/s, xDeepFM B=4096 {xdeepfm['ex_s']:.1f} "
          "ex/s", flush=True)
    train_cli_phase(ccfg)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": "cin_layer_fwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/cin_layer.cu",
         "replaces": "recsys_tpu/ops/pallas_cin.py:149",
         "launches": served["launches"],
         "max_abs_err": fwd["max_abs_err"],
         "ms": fwd["ms"], "plain_ms": fwd["plain_ms"]},
        {"name": "cin_layer_bwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/cin_backward.cu",
         "replaces": "recsys_tpu/ops/pallas_cin.py:180",
         "launches": xdeepfm["counts"]["cin_bwd"],
         "max_abs_err": bwd["max_abs_err"],
         "ms": bwd["ms"], "plain_ms": bwd["plain_ms"]},
        {"name": "segment_sum", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/segment_sum.cu",
         "replaces": "recsys_tpu/ops/pallas_kernels.py:334",
         "launches": deepfm["counts"]["segment_sum"],
         "max_abs_err": seg["max_abs_err"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
