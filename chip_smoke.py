#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``recsys_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA card and nvcc (CUDA_HOME or PATH)

It fails (exit code other than 0, no result line) without a CUDA device or
without the package beside it. On a card it

1. prints the card's name and power limit (nvidia-smi) and builds the four
   kernels from their sources, one nvcc each, all started together:
   ``csrc/cin_layer.cu`` (CIN forward), ``csrc/cin_backward.cu`` (CIN
   backward), ``csrc/segment_sum.cu`` (the embedding-gradient sum) and
   ``csrc/row_gather.cu`` (the embedding forward gather);
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
   - row gather: bitwise equal to ``index_select`` (a copy is exact) at
     DIN's item (63,002×32) and category (802×32) tables with 33,792 ids
     (B = 1024, P = 32, plus the targets), the Criteo big and small tables
     at batch 16384 with the engine's own ids, a ragged N, W = 1 and N = 0,
     rows 0 and V−1 always among the ids; timed at DIN's item table and
     the Criteo big table, as device time per call inside a CUDA graph (a
     copy of a few MB takes microseconds, less than a launch from Python)
     and as a host loop through the wrapper;
3. serving: full-width xDeepFM and full-width DIN with seeded random
   weights, exported, served over REST from a thread (xDeepFM at batches
   1, 200 and 4096, DIN at 1, 200 and 1024 with histories padded to 32;
   JSON, NPZ1, RAW1), every answer within 1e-4 of the CPU servable, each
   xDeepFM request launching the CIN forward 3 times and the row gather
   twice, each DIN request the row gather 4 times and the segment sum
   never; a request with an id out of range gets a 400 and the server
   keeps answering; then ``train_ctr serve`` and ``train_din serve``
   (``--device=cuda``) from the command line each answer one request;
4. training: full-width DeepFM at batch 16384 and full-width xDeepFM at
   batch 4096 through ``fast.make_scanned_train_step_devgen``, 200 steps in
   calls of K = 50 on a device-resident synthetic dataset. The loss must be
   finite and fall, each step must launch the segment sum and the row
   gather twice (and, for xDeepFM, the CIN forward and backward three times
   each), the eval AUC on held-out rows must beat the untrained model's by
   0.02, the CIN filters' gradients on the card must be non-zero, and 3
   steps at dropout 0 on the card must match the same 3 steps on the CPU
   (plain versions) within 1e-4 on every parameter (a tenth of one Adam
   step at lr 1e-3);
5. DIN training: full width (items 63,002, categories 802, D = 32,
   attention 80-40, MLP 100-50-20, dropout 0.1, Adam lr 1e-3) at batch
   1024 through ``loop.train_and_evaluate`` on host-fed batches of
   ``synthetic_din_hard`` (40,000 users), 300 steps: the loss must fall,
   each step must launch the segment sum 4 times and the row gather 4
   times, the held-out AUC must beat the untrained model's by 0.02, the
   tables' gradients on the card must be non-zero, and 3 steps at dropout
   0 must match the CPU within 1e-4;
6. ``train_ctr train`` and ``train_din train`` (``--device=cuda``) from the
   command line each exit 0, print an eval AUC and leave a checkpoint; then
   ``train_din export`` writes a servable that loads on the card.

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
import urllib.error

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
DIN_BATCHES = (1, 200, 1024)
DIN_STEPS = 300


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


def _graph_ms(fn, iters: int = 100) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so that the host's launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _read(counters: dict) -> dict:
    """{name: launches} of ``counters`` ({name: wrapper module})."""
    return {k: m.LAUNCHES for k, m in counters.items()}


def _zero(counters: dict) -> None:
    for m in counters.values():
        m.LAUNCHES = 0


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


def row_gather_phase(rg, ccfg, dev) -> dict:
    """Row-gather kernel vs ``index_select`` on the card, bitwise; times at
    DIN's item table and the Criteo big table: device time per call in a
    CUDA graph (ms: the sum of the two shapes), and the host loop through
    the wrapper, which is what the eager path pays per call."""
    from recsys_tpu_torch.core.config import EmbeddingConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.embeddings import engines

    gen = torch.Generator().manual_seed(7)
    n_din = DIN_BATCHES[-1] * (32 + 1)       # B·P history ids + B targets
    cases = [("DIN item table", 63_002, 32,
              torch.randint(0, 63_002, (n_din,), generator=gen), True),
             ("DIN category table", 802, 32,
              torch.randint(0, 802, (n_din,), generator=gen), False)]
    eng = engines.SplitEngine(EmbeddingConfig(ccfg.field_vocab_sizes, 16))
    shapes = eng.init(torch.Generator(), "meta")
    ids = torch.from_numpy(synthetic_criteo(16384, ccfg, start_row=999)[
        "ids"].astype(np.int64))
    for name, _, fields, offsets in eng._index_tensors("cpu"):
        cases.append((f"Criteo {name} table B=16384",
                      shapes[name].shape[0], 17,
                      (ids.index_select(1, fields) + offsets).reshape(-1),
                      name == "big"))
    cases += [("ragged", 1000, 17,
               torch.randint(0, 1000, (RAGGED_N,), generator=gen), False),
              ("W=1", 300, 1, torch.randint(0, 300, (1000,), generator=gen),
               False),
              ("N=0", 64, 32, torch.zeros(0, dtype=torch.int64), False)]
    max_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for label, v, w, gids, timed in cases:
        if gids.numel() >= 2:
            gids[:2] = torch.tensor([0, v - 1])
        table = torch.randn(v, w, generator=gen).to(dev)
        gids = gids.to(dev)
        got = rg.row_gather(table, gids)
        ref = torch.index_select(table, 0, gids)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item() if got.numel() else 0.0
        max_abs = max(max_abs, err)
        line = (f"row gather {label}: V={v} W={w} N={gids.shape[0]} "
                f"bitwise={torch.equal(got, ref)} max_abs_err={err:.3e}")
        if timed:
            lib, out = rg._lib(), torch.empty_like(got)

            def kern():
                err = lib.row_gather(
                    table.data_ptr(), gids.data_ptr(), out.data_ptr(),
                    gids.shape[0], w, v,
                    torch.cuda.current_stream().cuda_stream)
                _check(err == 0, f"row gather launch failed: {err}")

            def plain():
                torch.index_select(table, 0, gids, out=out)

            t = [_graph_ms(f) for f in (plain, kern, kern, plain)]
            k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            hk_ms, hp_ms = _timed_pair(lambda: rg.row_gather(table, gids),
                                       plain, 100)
            ms += k_ms
            plain_ms += p_ms
            line += (f" device: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f};"
                     f" host loop: wrapper_ms={hk_ms:.4f} "
                     f"plain_ms={hp_ms:.4f}")
        print(line, flush=True)
        _check(torch.equal(got, ref), f"row-gather kernel differs from "
                                      f"index_select ({label})")
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


def serving_phase(export_dir: str, requests: dict, bad: dict, name: str,
                  counters: dict, per_request: dict) -> dict:
    """REST serving on the card against the CPU servable, one request at a
    time: each batch of ``requests`` ({batch: features}) in JSON, NPZ1 and
    RAW1, every request adding ``per_request[k]`` launches to counter
    ``k``; then ``bad`` (an id out of range) must get a 400, launch
    nothing, and the server must keep answering. → p50 ms per batch,
    launches per counter over the served requests, request count."""
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
        refs = {b: sv_cpu.predict(f) for b, f in requests.items()}
        for feats in requests.values():                    # warm up
            client.rest_send(port, client.prepare_body(feats, "raw"))
        _zero(counters)                  # the serving path starts here
        n_req = 0
        for b, feats in requests.items():
            ref = refs[b]
            bodies = {fmt: client.prepare_body(feats, fmt)
                      for fmt in ("json", "npz", "raw")}
            lat = []
            for fmt in ["json", "npz"] + ["raw"] * LATENCY_REQUESTS:
                before = _read(counters)
                t0 = time.perf_counter()
                got = client.rest_send(port, bodies[fmt], name)
                dt = time.perf_counter() - t0
                n_req += 1
                if fmt == "raw":
                    lat.append(dt)
                after = _read(counters)
                delta = {k: after[k] - before[k] for k in counters}
                _check(delta == per_request,
                       f"{name} batch {b} {fmt}: kernel launches {delta}, "
                       f"want {per_request}")
                _check(got.shape == (b,) and bool(np.isfinite(got).all()),
                       f"{name} batch {b} {fmt}: answer shape {got.shape} "
                       "or values")
                err = float(np.abs(got - ref).max())
                _check(err <= TOL, f"{name} batch {b} {fmt}: |card - cpu| "
                                   f"= {err}")
            p50[b] = float(np.percentile(lat, 50) * 1e3)
            print(f"{name} served batch {b}: RAW1/JSON/NPZ1 within {TOL} of "
                  f"the CPU run; probs mean {ref.mean():.4f} std "
                  f"{ref.std():.4f}; p50 {p50[b]:.3f} ms p99 "
                  f"{np.percentile(lat, 99) * 1e3:.3f} ms over {len(lat)} "
                  "RAW1 requests", flush=True)
            _check(b == 1 or float(ref.std()) > 1e-3,
                   f"{name} batch {b}: probabilities do not vary; the check "
                   "is void")
        launches = _read(counters)       # the serving path ends here
        _check(all(launches[k] == per_request[k] * n_req for k in counters),
               f"{name}: {launches} kernel launches for {n_req} requests")
        try:
            client.rest_send(port, client.prepare_body(bad, "raw"), name)
            _check(False, f"{name}: a request with an id out of range was "
                          "answered")
        except urllib.error.HTTPError as e:
            _check(e.code == 400, f"{name}: bad request got HTTP {e.code}")
        _check(_read(counters) == launches,
               f"{name}: the rejected request launched a kernel")
        b, feats = next(iter(requests.items()))
        got = client.rest_send(port, client.prepare_body(feats, "json"), name)
        _check(float(np.abs(got - refs[b]).max()) <= TOL,
               f"{name}: the server did not recover from a bad request")
        print(f"{name}: an id out of range got HTTP 400 and no launch; the "
              "server answered the next request", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        thread.join(10)
    return {"launches": launches, "p50_ms": p50, "requests": n_req}


def _run_cli(module: str, args: list[str], timeout: float, until=None):
    """Run ``python -m recsys_tpu_torch.tools.<module> <args>``, echoing
    its output. With ``until`` (a function of one output line returning a
    value or None) the process is left running until a line gives a value,
    and (proc, value) is returned; without, it runs to its end and (exit
    code, output) is returned."""
    cmd = [sys.executable, "-m", f"recsys_tpu_torch.tools.{module}"] + args
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


def serve_cli_phase(module: str, export_dir: str, feats: dict) -> None:
    """The user's entry point: ``<module> serve --device=cuda`` from the
    command line answers one request as the CPU servable does."""
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable

    def port_of(line):
        m = re.search(r"REST:(\d+)", line)
        return int(m.group(1)) if m else None

    proc, port = _run_cli(module, ["serve", f"--export_dir={export_dir}",
                                   "--device=cuda", "--port=0"], 300,
                          until=port_of)
    try:
        got = client.rest_send(port, client.prepare_body(feats, "raw"))
        ref = Servable(export_dir, device="cpu").predict(feats)
        err = float(np.abs(got - ref).max())
        _check(err <= TOL, f"{module} serve: |card - cpu| = {err}")
        print(f"{module} serve on port {port}: batch {len(ref)} within {TOL} "
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


def train_phase(name, ccfg, mcfg, batch_size, dev, cin_kernel, ss,
                rg) -> dict:
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
    ss.LAUNCHES = rg.LAUNCHES = cin_kernel.LAUNCHES = 0
    cin_kernel.BWD_LAUNCHES = 0
    losses, t_calls = [], []
    for _ in range(TRAIN_STEPS // K):        # the training path starts here
        t0 = time.perf_counter()
        ts, loss = step_fn(ts, staged, K)
        losses.append(float(loss))           # one host read per call
        t_calls.append(time.perf_counter() - t0)
    counts = {"segment_sum": ss.LAUNCHES, "row_gather": rg.LAUNCHES,
              "cin_fwd": cin_kernel.LAUNCHES,
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
    _check(counts["segment_sum"] == 2 * steps and
           counts["row_gather"] == 2 * steps,
           f"{name}: segment-sum and row-gather launches {counts} for "
           f"{steps} steps, want {2 * steps} each (two tables)")
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
            "train_ctr",
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


def din_data():
    """Full-size DIN data (``synthetic_din_hard``, 40,000 users, the
    reference's vocabs) split as ``train_din`` splits it; → (train, eval)
    dicts of numpy arrays."""
    from recsys_tpu_torch.data import amazon
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB
    from recsys_tpu_torch.tools import train_din

    ds = amazon.synthetic_din_hard(n_users=40_000, item_vocab=ITEM_VOCAB,
                                   cate_vocab=CATE_VOCAB)
    train, evald = train_din.split_dataset(ds)
    _check(ds.hist_iid.shape[1] == 32, f"DIN histories padded to "
                                       f"{ds.hist_iid.shape[1]}, want 32")
    print(f"DIN data: {len(train['label'])} train and {len(evald['label'])} "
          f"held-out examples, histories padded to 32, "
          f"{float((ds.hist_iid == 0).mean()):.3f} of history ids padding",
          flush=True)
    return train, evald


def _din_model(dropout: float):
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB

    cfg = ModelConfig(name="din", embedding_dim=32, use_bn=False,
                      dropout=dropout)
    return make_model("din", ITEM_VOCAB, CATE_VOCAB, cfg), cfg


def din_train_phase(train, evald, dev, rg, ss) -> dict:
    """Train full-width DIN on the card through ``loop.train_and_evaluate``
    (host-fed batches) → counts and numbers of the main path's run."""
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.core.config import TrainConfig
    from recsys_tpu_torch.tools import train_din
    from recsys_tpu_torch.train import fast, loop
    from recsys_tpu_torch.train import train_state as TS

    b = DIN_BATCHES[-1]
    model, _ = _din_model(0.1)
    eval_fn = lambda: train_din.batch_iter(evald, b, seed=0,  # noqa: E731
                                           num_epochs=1)
    n_eval = len(evald["label"]) // b
    with tempfile.TemporaryDirectory() as model_dir:
        cfg = TrainConfig(batch_size=b, learning_rate=1e-3,
                          eval_every_steps=DIN_STEPS, log_every_steps=50,
                          save_checkpoints_steps=DIN_STEPS,
                          eval_steps=n_eval, model_dir=model_dir)
        ts0, _ = TS.create_train_state(model, cfg.seed, 1e-3, dev)
        auc0 = loop.evaluate(model, ts0.params, ts0.model_state, eval_fn(),
                             device=dev)["auc"]
        del ts0
        torch.cuda.synchronize()
        counters = {"segment_sum": ss, "row_gather": rg}
        _zero(counters)                  # the training path starts here
        m = loop.train_and_evaluate(
            model, train_din.batch_iter(train, b, cfg.seed), eval_fn, cfg,
            num_steps=DIN_STEPS, device=dev, resume=False)
        counts = _read(counters)         # ... and ends here
        ckpts = sorted(os.listdir(model_dir))
    print(f"DIN training at batch {b}: {DIN_STEPS} steps, logged loss "
          f"{m['first_loss']:.5f} -> {m['final_loss']:.5f}, eval AUC "
          f"{auc0:.4f} -> {m['auc']:.4f} on {int(m['count'])} held-out rows, "
          f"{m['examples_per_sec']:.1f} ex/s (steps {DIN_STEPS - 49}-"
          f"{DIN_STEPS}), "
          f"{m['train_seconds']:.2f} s in all, launches {counts}, "
          f"checkpoints {ckpts}", flush=True)
    _check(np.isfinite(m["first_loss"]) and np.isfinite(m["final_loss"]),
           f"DIN: loss {m['first_loss']} -> {m['final_loss']}")
    _check(m["final_loss"] < m["first_loss"],
           f"DIN: loss did not fall: {m['first_loss']} -> {m['final_loss']}")
    _check(counts["segment_sum"] == 4 * DIN_STEPS,
           f"DIN: {counts['segment_sum']} segment-sum launches for "
           f"{DIN_STEPS} steps, want {4 * DIN_STEPS}")
    _check(counts["row_gather"] == 4 * (DIN_STEPS + n_eval),
           f"DIN: {counts['row_gather']} row-gather launches for "
           f"{DIN_STEPS} steps and {n_eval} eval batches, want "
           f"{4 * (DIN_STEPS + n_eval)}")
    _check(m["auc"] >= auc0 + AUC_MARGIN,
           f"DIN: eval AUC {m['auc']} after training, {auc0} before")
    _check(f"step_{DIN_STEPS}" in ckpts, f"DIN: checkpoints {ckpts}")

    # the tables' gradients on the card (fresh weights, dropout 0) are
    # non-zero and agree with the CPU's
    model0, _ = _din_model(0.0)
    batch = next(train_din.batch_iter(train, b, seed=5))
    grads = []
    for d in ("cpu", dev):
        ts, _ = TS.create_train_state(model0, 1, 1e-3, d)
        _, _, g = TS.loss_and_grads(model0, ts.params, ts.model_state,
                                    fast.stage_dataset(batch, d))
        grads.append({k: g[k].cpu() for k in ("item_emb", "cate_emb")})
    gmax = {}
    for k in ("item_emb", "cate_emb"):
        gmax[k] = float(grads[1][k].abs().max())
        err = float((grads[1][k] - grads[0][k]).abs().max())
        _check(gmax[k] > 0 and err <= 1e-4 * float(grads[0][k].abs().max()),
               f"DIN: {k} gradient on the card max {gmax[k]}, differs from "
               f"the CPU's by {err}")

    # 3 steps at dropout 0, card vs CPU
    out = []
    for d in ("cpu", dev):
        ts, tx = TS.create_train_state(model0, 11, 1e-3, d)
        step = TS.make_train_step(model0, tx)
        for batch in list(train_din.batch_iter(train, b, seed=9,
                                                 num_epochs=1))[:3]:
            ts, loss = step(ts, fast.stage_dataset(batch, d))
        out.append((float(loss), tree.leaves(ts.params)))
    (l_cpu, p_cpu), (l_dev, p_dev) = out
    _check(abs(l_cpu - l_dev) <= 1e-5 * abs(l_cpu),
           f"DIN: 3-step loss card {l_dev} vs cpu {l_cpu}")
    diff = max(float((q.cpu() - p).abs().max()) for p, q in zip(p_cpu, p_dev))
    _check(diff <= STEP_TOL, f"DIN: params after 3 steps differ by {diff} "
                             f"between card and CPU (tolerance {STEP_TOL})")
    print(f"DIN: max |grad| on the card item_emb {gmax['item_emb']:.3e} "
          f"cate_emb {gmax['cate_emb']:.3e} (within 1e-4 of the CPU's); 3 "
          f"steps at dropout 0 match the CPU: max |param diff| {diff:.3e} "
          f"(tolerance {STEP_TOL})", flush=True)
    return {"counts": counts, "ex_s": m["examples_per_sec"],
            "auc": (auc0, m["auc"])}


def din_cli_phase() -> None:
    """``train_din train --device=cuda`` at full width, then
    ``train_din export``; the servable loads and answers on the card."""
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB
    from recsys_tpu_torch.serve.export import Servable

    with tempfile.TemporaryDirectory() as tmp:
        common = ["--device=cuda", "--synthetic_users=40000",
                  f"--item_vocab={ITEM_VOCAB}", f"--cate_vocab={CATE_VOCAB}",
                  "--train.batch_size=1024", f"--train.model_dir={tmp}/model"]
        code, out = _run_cli(
            "train_din", ["train", "--train.num_steps=100",
                          "--train.eval_every_steps=50",
                          "--train.log_every_steps=50"] + common, 600)
        _check(code == 0, f"train_din train exited with {code}")
        m = re.search(r"'auc': ([0-9.]+)", out)
        _check(m is not None, "train_din train printed no eval AUC")
        ckpts = sorted(os.listdir(f"{tmp}/model"))
        _check("step_100" in ckpts, f"no checkpoint step_100 in {ckpts}")
        code, _ = _run_cli("train_din", ["export",
                                         f"--export_dir={tmp}/export"]
                           + common, 600)
        _check(code == 0, f"train_din export exited with {code}")
        sv = Servable(f"{tmp}/export", device="cuda")
        probs = sv.predict(sv._sample_features(8))
        _check(probs.shape == (8,) and bool(np.isfinite(probs).all()),
               f"exported DIN servable answered {probs}")
        print(f"command-line DIN training: eval AUC {m.group(1)}, "
              f"checkpoints {ckpts}; the exported servable answers on the "
              "card", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB
    from recsys_tpu_torch.ops import cin_kernel, cuda_build
    from recsys_tpu_torch.ops import row_gather as rg
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

    sources = [cin_kernel.SOURCE, cin_kernel.BWD_SOURCE, ss.SOURCE, rg.SOURCE]
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
    gat = row_gather_phase(rg, ccfg, dev)
    print(f"kernel phases ok [{card}]: CIN fwd {fwd['ms']:.4f} ms vs plain "
          f"{fwd['plain_ms']:.4f} ms, CIN bwd {bwd['ms']:.4f} ms vs plain "
          f"{bwd['plain_ms']:.4f} ms (three layers at B=4096); segment sum "
          f"{seg['ms']:.4f} ms vs plain {seg['plain_ms']:.4f} ms (both "
          f"tables at B=16384); row gather {gat['ms']:.4f} ms vs "
          f"index_select {gat['plain_ms']:.4f} ms of device time (DIN item "
          "table at B=1024 plus Criteo big table at B=16384)", flush=True)

    model = make_model("xdeepfm", ccfg, xcfg)
    params, state = randomize(*model.init(torch.Generator().manual_seed(0),
                                          "cpu"), seed=1)
    reqs = {}
    for i, b in enumerate(BATCHES):
        d = synthetic_criteo(b, ccfg, start_row=10_000 * i)
        reqs[b] = {"ids": d["ids"], "dense": d["dense"]}
    bad = {"ids": reqs[1]["ids"].copy(), "dense": reqs[1]["dense"]}
    bad["ids"][0, -1] = ccfg.field_vocab_sizes[-1]
    with tempfile.TemporaryDirectory() as export_dir:
        export_servable(export_dir, "xdeepfm", params, state, xcfg, ccfg)
        served = serving_phase(
            export_dir, reqs, bad, "xdeepfm",
            {"cin_fwd": cin_kernel, "row_gather": rg, "segment_sum": ss},
            {"cin_fwd": 3, "row_gather": 2, "segment_sum": 0})
        serve_cli_phase("train_ctr", export_dir, reqs[200])

    din_train, din_eval = din_data()
    din_model, din_cfg = _din_model(0.1)
    params, state = randomize(*din_model.init(
        torch.Generator().manual_seed(0), "cpu"), seed=2)
    reqs = {b: {k: din_eval[k][:b] for k in ("i_id", "i_cate", "hist_iid",
                                             "hist_cate")}
            for b in DIN_BATCHES}
    bad = dict(reqs[1], hist_iid=reqs[1]["hist_iid"].copy())
    bad["hist_iid"][0, 0] = ITEM_VOCAB
    with tempfile.TemporaryDirectory() as export_dir:
        export_servable(export_dir, "din", params, state, din_cfg,
                        factory_kwargs={"item_vocab": ITEM_VOCAB,
                                        "cate_vocab": CATE_VOCAB})
        din_served = serving_phase(
            export_dir, reqs, bad, "din",
            {"row_gather": rg, "segment_sum": ss},
            {"row_gather": 4, "segment_sum": 0})
        serve_cli_phase("train_din", export_dir, reqs[200])
    print("served p50 latency (REST, RAW1, one request at a time): xDeepFM "
          + ", ".join(f"batch {b}: {ms:.3f} ms"
                      for b, ms in served["p50_ms"].items())
          + "; DIN " + ", ".join(f"batch {b}: {ms:.3f} ms"
                                 for b, ms in din_served["p50_ms"].items())
          + f" [{card}]", flush=True)

    deepfm = train_phase("deepfm", ccfg, ModelConfig(name="deepfm"), 16384,
                         dev, cin_kernel, ss, rg)
    xdeepfm = train_phase("xdeepfm", ccfg, xcfg, 4096, dev, cin_kernel, ss,
                          rg)
    din = din_train_phase(din_train, din_eval, dev, rg, ss)
    print(f"training throughput [{card}]: DeepFM B=16384 "
          f"{deepfm['ex_s']:.1f} ex/s, xDeepFM B=4096 {xdeepfm['ex_s']:.1f} "
          f"ex/s, DIN B=1024 {din['ex_s']:.1f} ex/s", flush=True)
    train_cli_phase(ccfg)
    din_cli_phase()
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    print(json.dumps({"kernels": [
        {"name": "cin_layer_fwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/cin_layer.cu",
         "replaces": "recsys_tpu/ops/pallas_cin.py:149",
         "launches": served["launches"]["cin_fwd"],
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
         "also_replaces": "recsys_tpu/ops/pallas_kernels.py:154",
         "note": "launches: DeepFM training; the :154 contract (row-major) "
                 "is reached by DIN's four table gathers, "
                 f"{din['counts']['segment_sum']} launches in DIN training",
         "launches": deepfm["counts"]["segment_sum"],
         "max_abs_err": seg["max_abs_err"],
         "ms": seg["ms"], "plain_ms": seg["plain_ms"]},
        {"name": "row_gather", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/row_gather.cu",
         "replaces": "scratch/rowdma_kernel.py:72",
         "note": "launches: DIN training (4 per step plus eval); ms: "
                 "device time in a CUDA graph, DIN item table at B=1024 "
                 "plus Criteo big table at B=16384",
         "launches": din["counts"]["row_gather"],
         "max_abs_err": gat["max_abs_err"],
         "ms": gat["ms"], "plain_ms": gat["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
