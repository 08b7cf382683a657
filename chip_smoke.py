#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``recsys_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA card and nvcc (CUDA_HOME or PATH)

It fails (exit code other than 0, no result line) without a CUDA device or
without the package beside it. On a card it

1. prints the card's name and power limit (nvidia-smi) and builds the CIN
   kernel (``recsys_tpu_torch/csrc/cin_layer.cu``) from the source;
2. kernel phase: compares the kernel with its plain PyTorch version on the
   card for the three CIN layers of full-width xDeepFM, at N = 16·B rows
   for B in 1, 200, 4096 and at a ragged N (tolerance 1e-4 absolute and
   relative: 1521-term float32 sums in another order than cuBLAS), and
   times both at B = 4096 with CUDA events;
3. slice phase: builds full-width xDeepFM (``CriteoConfig()``, embedding
   dim 16, CIN 20-10-10, DNN 100-100 with batch norm) from a seeded
   generator, fills every leaf with seeded noise, exports it as a
   servable, loads it on the card and on the CPU, serves it over REST from
   a thread, and sends JSON, NPZ1 and RAW1 requests at batches 1, 200 and
   4096. Every answer must be finite, of the right shape, and within 1e-4
   of the CPU servable's (the plain versions); each request must launch
   the kernel 3 times. It reports the p50 request latency per batch;
4. command-line phase: starts ``python -m recsys_tpu_torch.tools.train_ctr
   serve --device=cuda --port=0`` on the same servable, checks one answer
   and stops it.

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
RAGGED_N = 3333          # not a multiple of the kernel's 128-row tile
TOL = 1e-4
LATENCY_REQUESTS = 30


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


def kernel_phase(cin_kernel, layers, dev) -> dict:
    """Kernel vs plain version on the card: errors at every shape, times at
    B = 4096 (order plain, kernel, kernel, plain; the two runs averaged)."""
    gen = torch.Generator().manual_seed(1234)
    max_abs, ms, plain_ms = 0.0, 0.0, 0.0
    for n in [16 * b for b in BATCHES] + [RAGGED_N]:
        for f0, fk, h in layers:
            lim = (6.0 / (f0 * fk + h)) ** 0.5
            x0v = torch.randn(n, f0, generator=gen).to(dev)
            xkv = torch.randn(n, fk, generator=gen).to(dev)
            w = torch.empty(f0 * fk, h).uniform_(-lim, lim, generator=gen).to(dev)
            b = (0.1 * torch.randn(h, generator=gen)).to(dev)
            got = cin_kernel.cin_layer(x0v, xkv, w, b)
            ref = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            rel = (err / ref.abs().clamp_min(1e-6)).max().item()
            ok = bool(torch.isfinite(got).all()) and bool(
                (err <= TOL + TOL * ref.abs()).all())
            max_abs = max(max_abs, err.max().item())
            # both against float64: shows each is off by rounding only
            ref64 = cin_kernel.cin_layer_reference(
                x0v.double(), xkv.double(), w.double(), b.double())
            line = (f"kernel N={n} F0={f0} Fk={fk} H={h}: max_abs_err="
                    f"{err.max().item():.3e} max_rel_err={rel:.3e}; vs f64: "
                    f"kernel {(got - ref64).abs().max().item():.3e} plain "
                    f"{(ref - ref64).abs().max().item():.3e}")
            if n == 16 * BATCHES[-1]:
                kern = lambda: cin_kernel.cin_layer(x0v, xkv, w, b)  # noqa: E731
                plain = lambda: cin_kernel.cin_layer_reference(  # noqa: E731
                    x0v, xkv, w, b)
                t = [_cuda_ms(f, 50) for f in (plain, kern, kern, plain)]
                k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
                ms += k_ms
                plain_ms += p_ms
                line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            print(line, flush=True)
            _check(ok, f"kernel disagrees with its plain version at N={n} "
                       f"Fk={fk} H={h}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def randomize(params, state, seed: int):
    """Every leaf replaced by seeded noise of its shape: BN var in [0.5, 2];
    the biases of the three one-unit branch outputs in [1, 2], so that
    their ReLUs stay alive; the rest is the initial value plus noise of
    0.3 times its spread (0.1 where the initial value is constant), so
    activations keep the scale of the initializers and the probabilities do
    not saturate. Without it fresh init leaves branches dead and answers
    0.5."""
    from recsys_tpu_torch.core import checkpoint
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
    return checkpoint.fill_like([params, state], leaves)


def slice_phase(cin_kernel, export_dir: str, ccfg) -> dict:
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
        cin_kernel.LAUNCHES = 0          # the main path starts here
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
        launches = cin_kernel.LAUNCHES   # the main path ends here
        _check(launches == 3 * n_req,
               f"{launches} kernel launches for {n_req} requests")
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        thread.join(10)
    return {"launches": launches, "p50_ms": p50, "requests": n_req}


def cli_phase(export_dir: str, ccfg) -> None:
    """The user's entry point: serve from the command line, one request."""
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable

    cmd = [sys.executable, "-m", "recsys_tpu_torch.tools.train_ctr", "serve",
           f"--export_dir={export_dir}", "--device=cuda", "--port=0"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stderr=subprocess.PIPE, text=True)
    lines: queue.Queue = queue.Queue()

    def drain():
        for line in proc.stderr:
            lines.put(line)

    threading.Thread(target=drain, daemon=True).start()
    try:
        deadline = time.monotonic() + 300
        port = None
        while port is None:
            _check(proc.poll() is None, f"{' '.join(cmd)} exited with "
                                        f"{proc.returncode}")
            _check(time.monotonic() < deadline, "command-line server did "
                                                "not start in 300 s")
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            print("  serve: " + line.rstrip(), flush=True)
            m = re.search(r"REST:(\d+)", line)
            port = int(m.group(1)) if m else None
        d = synthetic_criteo(200, ccfg, start_row=77)
        feats = {"ids": d["ids"], "dense": d["dense"]}
        got = client.rest_send(port, client.prepare_body(feats, "raw"))
        ref = Servable(export_dir, device="cpu").predict(feats)
        err = float(np.abs(got - ref).max())
        _check(err <= TOL, f"command-line server: |card - cpu| = {err}")
        print(f"command-line server on port {port}: batch 200 within {TOL} "
              "of the CPU run", flush=True)
    finally:
        proc.terminate()
        try:
            proc.wait(20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(20)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.ops import cin_kernel
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

    t0 = time.perf_counter()
    lib = cin_kernel.build()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(lib + ".log") as f:
        spills = [l.strip() for l in f if "spill" in l and " 0 bytes spill "
                  not in l]
    print("ptxas spills: " + ("; ".join(spills) if spills else "none"),
          flush=True)

    ccfg, mcfg = CriteoConfig(), ModelConfig(name="xdeepfm")
    f0 = len(ccfg.field_vocab_sizes)
    # (F0, Fk, H) of each CIN layer: 39 fields, then each layer's width
    fks = (f0,) + tuple(mcfg.cin_layers[:-1])
    layers = [(f0, fk, h) for fk, h in zip(fks, mcfg.cin_layers)]
    stats = kernel_phase(cin_kernel, layers, torch.device("cuda"))
    print(f"kernel phase ok: max_abs_err {stats['max_abs_err']:.3e}; three "
          f"layers at B=4096 (N=65536): kernel {stats['ms']:.4f} ms, plain "
          f"{stats['plain_ms']:.4f} ms [{card}]", flush=True)

    model = make_model("xdeepfm", ccfg, mcfg)
    params, state = randomize(*model.init(torch.Generator().manual_seed(0),
                                          "cpu"), seed=1)
    with tempfile.TemporaryDirectory() as export_dir:
        export_servable(export_dir, "xdeepfm", params, state, mcfg, ccfg)
        served = slice_phase(cin_kernel, export_dir, ccfg)
        cli_phase(export_dir, ccfg)
    print("served p50 latency (REST, RAW1, one request at a time): "
          + ", ".join(f"batch {b}: {ms:.3f} ms"
                      for b, ms in served["p50_ms"].items())
          + f" [{card}]", flush=True)

    print(json.dumps({"kernels": [{
        "name": "cin_layer_fwd", "route": "cuda",
        "source": "recsys_tpu_torch/csrc/cin_layer.cu",
        "replaces": "recsys_tpu/ops/pallas_cin.py:149",
        "launches": served["launches"],
        "max_abs_err": stats["max_abs_err"],
        "ms": stats["ms"], "plain_ms": stats["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
