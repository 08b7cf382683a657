#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``recsys_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA card and nvcc (CUDA_HOME or PATH)

It fails (exit code other than 0, no result line) without a CUDA device or
without the package beside it. On a card it

1. prints the card's name and power limit (nvidia-smi) and builds the five
   kernel sources, one nvcc each, all started together:
   ``csrc/cin_layer.cu`` (CIN forward), ``csrc/cin_backward.cu`` (CIN
   backward), ``csrc/segment_sum.cu`` (the embedding-gradient sum),
   ``csrc/row_gather.cu`` (the embedding forward gather) and
   ``csrc/reshape_probe.cu`` (the two reshape probes);
2. kernel phases, each kernel against its plain PyTorch version on the card
   at the main paths' shapes, timed with CUDA events in the order plain,
   kernel, kernel, plain, beside the one PyTorch call that computes the
   same function where there is one (``index_add_``, ``index_select``,
   ``torch.mul``) and the kernel's bound (the larger of its bytes over
   3.35 TB/s and its operations over the 67 TFLOP/s float32 peak):
   - CIN forward and backward: the three layers of full-width xDeepFM at
     N = 16·B rows for B in 1, 200, 4096 and at a ragged N (forward
     tolerance 1e-4 absolute and relative: 1521-term float32 sums in
     another order than cuBLAS; backward the same for dx0/dxk, and for
     dW/db, sums over all N rows, 1e-4 relative plus 1e-4·N/1024
     absolute), both bitwise equal across two calls and after a
     CUDA-graph replay at every shape; timed at B = 4096 back to back and
     as device time in a CUDA graph (the forward's device time also at
     B = 1 and 200, the serving shapes), with the backward's device time
     split by device operation (``torch.profiler``) at each layer;
   - segment sum: the big (837,632 rows) and small (4,096 rows) tables of
     DeepFM at batch 16384 with the engine's own ids, the fused engine's
     one table (638,976 ids into 840,704 × 17) and the wide model's
     weights (the same ids into 840,704 × 1), ragged N at W = 1, 8, 16,
     17, 32, 33, a power-of-two table whose last row is hit, ids out of
     range (dropped: held against the plain version of the ids in range),
     one id for every update, and N = 0 (tolerance 1e-5 of the row's Σ|g|:
     sums in another order), bitwise equal across two calls and after a
     CUDA-graph replay; timed at batch 16384 as device time in a CUDA
     graph and back to back, beside ``index_add_`` into a zeroed buffer and
     the whole function ``torch.zeros(rows, W).index_add_(…)``, with each
     device operation's time per call from ``torch.profiler``;
   - row gather: bitwise equal to ``index_select`` (a copy is exact) at
     DIN's item (63,002×32) and category (802×32) tables with 33,792 ids
     (B = 1024, P = 32, plus the targets), the Criteo big and small tables
     at batch 16384 with the engine's own ids, the fused engine's table
     (840,704×17, 638,976 ids), a ragged N, W = 1 and N = 0, rows 0 and
     V−1 always among the ids; timed at DIN's item table, the Criteo big
     table and the fused table, as device time per call inside a CUDA graph (a
     copy of a few MB takes microseconds, less than a launch from Python)
     and as a host loop through the wrapper;
   - reshape probes (``via_reshape`` and ``via_2d``, the counterparts of
     the TPU compiler probes S2 and S3): first each entry point once at
     VP = 837,632, W = 17 (the launches counted), then bitwise equal to
     the plain version there and at a ragged length, timed as a host loop
     and as device time in a CUDA graph beside ``torch.mul(x, 2.0)``;
3. serving: full-width xDeepFM, DCN and DIN with seeded random weights,
   exported, each loaded graphed (the default on the card) and eagerly
   (``graphed=False``): ``warmup`` must capture one CUDA graph per batch
   bucket (1, 8, 64, 256, 1024, 4096), and each request's graphed answer
   must be bitwise the eager one at the same padded shape (xDeepFM and DCN
   at batches 1, 200 and 4096, DIN at 1, 200 and 1024 with histories
   padded to 32) and within 1e-4 of the CPU servable; then, one request at
   a time, served over REST from a thread (JSON, NPZ1, RAW1) and over the
   socket front end (RAW1), every answer within 1e-4 of the CPU servable,
   each xDeepFM request launching the CIN forward 3 times and the row
   gather twice, each DCN request the row gather twice, each DIN request
   the row gather 5 times (its item bias too), and none the segment sum,
   under replay; a request with an id out of range gets a 400 and an error
   frame, launches nothing, and both fronts keep answering; the in-process
   predict's p50 and p99, graphed against eager, in 3 alternating pairs,
   and at xDeepFM batch 4096 each mode's host launch calls, device busy
   time and idle share a predict (``torch.profiler``); the NumPy engine on
   the host (xDeepFM, DCN) within ``rtol 2e-4, atol 2e-6`` of the CPU
   servable, its p50 at batches 1 and 200; a race of 8 REST client
   threads, 50 requests each of mixed batches (1 to 1,024 rows and some
   of 3,000, so that coalesced groups pass 4,096 rows and capture while
   serving), every answer within 1e-4 of its own CPU answer; then
   ``train_ctr serve`` and ``train_din serve`` (``--device=cuda``) from
   the command line each answer over REST and the socket (and gRPC where
   ``grpcio`` is installed; where it is not, the command must say that it
   does not serve gRPC);
4. training, full width at batch 16384 (xDeepFM at 4096) through
   ``fast.make_scanned_train_step_devgen`` in calls of K = 50 on a
   device-resident synthetic dataset, each step one replay of a captured
   CUDA graph (the eval calls too), 200 steps each: DeepFM, xDeepFM,
   DCN, FM, DeepFM and DNN on the fused engine, and the wide model (FTRL
   at alpha 4.0, as the JAX results protocol trains it). The loss must be
   finite and fall, each step must launch
   the segment sum and the row gather once per table read (twice on the
   split engine, once on the fused engine and for wide; for xDeepFM also
   the CIN forward and backward three times each), the eval AUC on
   held-out rows must beat the untrained model's by 0.02, the CIN filters'
   gradients on the card must be non-zero, and 3 steps at dropout 0 on the
   card must match the same 3 steps on the CPU (plain versions) within
   1e-4 on every parameter (a tenth of one Adam step at lr 1e-3); for DNN,
   whose small table gradients make Adam's first steps amplify float32
   rounding past 1e-4, every gradient of one batch must match the CPU's
   within 1e-4 of its leaf's largest instead; the launch counts are
   those of the kernels that ran, the graph's replays included; then, for
   DeepFM, wide and xDeepFM, the graphed call against the same call run
   eagerly from Python, from two states of one seed: every parameter, BN
   stat and optimizer leaf bitwise equal after 50 steps and after 210,
   the ex/s of each in 3 pairs of 50-step calls in alternating order, and
   the host's kernel and graph launch calls a step of each
   (``torch.profiler``, 10 steps);
5. DIN training: full width (items 63,002, categories 802, D = 32,
   attention 80-40, MLP 100-50-20, dropout 0.1, Adam lr 1e-3) at batch
   1024 through ``loop.train_and_evaluate`` on host-fed batches of
   ``synthetic_din_hard`` (40,000 users; through ``device_prefetch``, each
   step one replay of a captured CUDA graph), 300 steps: the loss must fall,
   each step must launch the segment sum 5 times and the row gather 5
   times, the held-out AUC must beat the untrained model's by 0.02, the
   tables' gradients on the card must be non-zero, and 3 steps at dropout
   0 must match the CPU within 1e-4;
6. streaming DeepFM, full width at batch 16384: 1,048,576 synthetic rows
   in 16 npz shards (and one more held out) on local disk, 200 steps
   through ``loop.train_and_evaluate`` (``ShardSource``,
   ``device_prefetch``, the graphed host-fed step): the loss must fall, the
   held-out AUC rise by 0.02, each step launch the segment sum and the
   row gather twice (honest counts under replay); then the host-fed step
   graphed against the same step run eagerly, from one seed over the same
   50 batches (every parameter, BN stat, optimizer leaf and loss bitwise
   equal), the ex/s of each in 3 alternating pairs of 50-step runs with
   the share of the wall time the consumer waited on the prefetch queue,
   and the ex/s of the fast path on the same rows;
7. DIN's host-fed step graphed against eager the same way, at batch 1024;
8. ``train_ctr train`` (DeepFM, and DCN on the fused engine) and
   ``train_din train`` (``--device=cuda``) from the command line each exit
   0, print an eval AUC and leave a checkpoint, ``best/`` (the step of the
   highest eval AUC), ``scalars.jsonl`` with the JAX loops' tags at their
   steps and one TensorBoard event file with a record (its crc32c checked)
   for each scalar line; then ``train_din export`` writes a servable that
   loads on the card;
9. a 262,144-line Criteo-format TSV (about 20% of numeric and 10% of
   categorical fields missing): the native host library must have built,
   its parse must equal the pure-Python path on the first 5,000 rows, and
   ``preprocess_tsv`` shards it (rows/s printed); ``train_ctr train
   --streaming --device=cuda`` trains 100 steps on the shards and prints
   an eval line, and ``train_ctr eval`` runs on the checkpoint it left.

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
GRAPH_TOL = 0.0          # graphed against eager: bitwise
GRAPH_PAIRS = 3
DIN_BATCHES = (1, 200, 1024)
RACE_BIG = 3000          # rows of the race's large requests
DIN_STEPS = 300
STREAM_SHARDS = 16
STREAM_ROWS = 16 * 65_536      # 1,048,576 rows, about 220 MB of npz
STREAM_STEPS = 200
FED_STEPS = 50                 # graphed against eager, and each timed run
TSV_ROWS = 262_144
TSV_CHECK_ROWS = 5_000
WIDE_LR = 4.0            # FTRL alpha on batch-mean gradients (results.py)
PROBE_ROWS, PROBE_W = 837_632, 17
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


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


def _replays_bitwise(fn) -> bool:
    """One call of ``fn`` (→ tuple of tensors) captured in a CUDA graph and
    replayed gives bitwise what an eager call gives."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(out, fn()))


def _read(counters: dict) -> dict:
    """{name: launches} of ``counters`` ({name: wrapper module})."""
    return {k: m.LAUNCHES for k, m in counters.items()}


def _zero(counters: dict) -> None:
    for m in counters.values():
        m.LAUNCHES = 0


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``flops`` float32 operations, against the H100 SXM's 3.35 TB/s
    and 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _cin_fwd_work(n, f0, fk, h) -> tuple[float, float]:
    """(bytes, flops) of one CIN layer forward: read x0v, xkv, W, b, write
    y; the outer product, the [N, F0·Fk] @ [F0·Fk, H] product, bias and
    ReLU."""
    nbytes = 4 * (n * f0 + n * fk + f0 * fk * h + h + n * h)
    return nbytes, n * f0 * fk + 2 * n * f0 * fk * h + 2 * n * h


def _cin_bwd_work(n, f0, fk, h) -> tuple[float, float]:
    """(bytes, flops) of one CIN layer backward: read x0v, xkv, W, y, dy,
    write dx0, dxk, dW, db; dz = g·Wᵀ, dx0 and dxk from dz, z again for
    dW = zᵀg, db."""
    nbytes = 4 * (2 * (n * f0 + n * fk + f0 * fk * h + n * h) + h)
    flops = (2 * n * h * f0 * fk + 4 * n * f0 * fk + n * f0 * fk
             + 2 * n * f0 * fk * h + 2 * n * h)
    return nbytes, flops


def _cin_inputs(gen, n, f0, fk, h, dev):
    lim = (6.0 / (f0 * fk + h)) ** 0.5
    x0v = torch.randn(n, f0, generator=gen).to(dev)
    xkv = torch.randn(n, fk, generator=gen).to(dev)
    w = torch.empty(f0 * fk, h).uniform_(-lim, lim, generator=gen).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    return x0v, xkv, w, b


def cin_forward_phase(cin_kernel, layers, dev) -> dict:
    """CIN forward kernel vs plain version: errors, bitwise repeats and
    CUDA-graph replays at every shape; device time in a CUDA graph at every
    N = 16·B (the serving and training shapes), back-to-back times at
    B = 4096."""
    gen = torch.Generator().manual_seed(1234)
    max_abs, ms, plain_ms, bound_ms, graph_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    biggest = (0.0, "operations")
    per_layer, graph_by_n = [], {}
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
            _check(ok, f"CIN forward kernel disagrees with its plain version "
                       f"at N={n} Fk={fk} H={h}")

            def kern():
                return cin_kernel.cin_layer_fwd(x0v, xkv, w, b)

            _check(torch.equal(kern(), got),
                   f"CIN forward kernel not deterministic at N={n} Fk={fk}")
            _check(_replays_bitwise(lambda: (kern(),)),
                   f"CIN forward replayed in a CUDA graph differs from an "
                   f"eager call at N={n} Fk={fk}")
            line += " bitwise_repeat=True graph_replay_bitwise=True"
            if n != RAGGED_N:
                g_ms = _graph_ms(kern)
                graph_by_n.setdefault(n, []).append(g_ms)
                line += f" graph_ms={g_ms:.4f}"
            if n == 16 * BATCHES[-1]:
                k_ms, p_ms = _timed_pair(
                    kern,
                    lambda: cin_kernel.cin_layer_reference(x0v, xkv, w, b),
                    50)
                b_ms, b_by = _bound(*_cin_fwd_work(n, f0, fk, h))
                if b_ms > biggest[0]:
                    biggest = (b_ms, b_by)
                ms += k_ms
                plain_ms += p_ms
                bound_ms += b_ms
                graph_ms += g_ms
                per_layer.append({"fk": fk, "h": h, "graph_ms": g_ms,
                                  "ms": k_ms, "bound_ms": b_ms})
                line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                         f"bound_ms={b_ms:.4f}")
            print(line, flush=True)
    # the bound is the sum of the layers' bounds; what bounds the largest
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": biggest[1],
            "library_ms": None, "graph_ms": graph_ms, "layers": per_layer,
            "graph_ms_by_n": {str(n): t for n, t in graph_by_n.items()}}


def cin_backward_phase(cin_kernel, layers, dev) -> dict:
    """CIN backward kernel vs plain version: errors at every shape, times
    at B = 4096."""
    gen = torch.Generator().manual_seed(4321)
    max_abs, ms, plain_ms, bound_ms, graph_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    biggest = (0.0, "operations")
    per_layer = []
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

            def kern():
                return cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)

            _check(_replays_bitwise(kern),
                   f"CIN backward replayed in a CUDA graph differs from an "
                   f"eager call at N={n} Fk={fk}")
            line += " bitwise_repeat=True graph_replay_bitwise=True"
            if n == 16 * BATCHES[-1]:
                k_ms, p_ms = _timed_pair(
                    kern, lambda: cin_kernel.cin_layer_backward_reference(
                        x0v, xkv, w, y, dy), 20)
                g_ms = _graph_ms(kern)
                parts = _device_breakdown(kern)
                b_ms, b_by = _bound(*_cin_bwd_work(n, f0, fk, h))
                if b_ms > biggest[0]:
                    biggest = (b_ms, b_by)
                ms += k_ms
                plain_ms += p_ms
                bound_ms += b_ms
                graph_ms += g_ms
                per_layer.append({
                    "fk": fk, "h": h, "graph_ms": g_ms, "ms": k_ms,
                    "bound_ms": b_ms,
                    "breakdown": [[k, round(t, 5), c] for k, t, c in parts]})
                line += (f" kernel_ms={k_ms:.4f} graph_ms={g_ms:.4f} "
                         f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f}\n  per "
                         "call on the device: " + "; ".join(
                             f"{k} {t:.4f} ms x{c:g}" for k, t, c in parts))
            print(line, flush=True)
    # the bound is the sum of the layers' bounds; what bounds the largest
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": biggest[1],
            "library_ms": None, "graph_ms": graph_ms, "layers": per_layer}


def _segment_sum_bytes(n: int, w: int, rows: int) -> int:
    """Bytes a segment sum must move: ids [N] int64 and grads [N, W] read
    once, the dense [rows, W] float32 table written once."""
    return 8 * n + 4 * n * w + 4 * rows * w


def _device_breakdown(fn, calls: int = 10) -> list:
    """[(device operation, ms per call, launches per call)] of ``fn`` under
    ``torch.profiler`` over ``calls`` calls, the costliest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.tools.profile_step import _device_time_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = [(evt.key[:70], _device_time_us(evt) / 1e3 / calls,
            evt.count / calls) for evt in prof.key_averages()
           if evt.device_type == DeviceType.CUDA]
    return sorted(out, key=lambda r: -r[1])


def segment_sum_phase(ss, ccfg, dev) -> dict:
    """Segment-sum kernel vs plain version on the card, timed at batch
    16384 at each engine's shapes: the split engine's two tables, the fused
    engine's one, the wide model's weights; plus widths 1 to 33, a ragged N,
    one id for every update, N = 0, a power-of-two table whose last row is
    hit, ids out of range (dropped), and the call replayed in a CUDA graph.
    → numbers of the fused engine's shape (the slice's main path) plus every
    timed shape under ``shapes``."""
    from recsys_tpu_torch.core.config import EmbeddingConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.embeddings import engines

    emb_cfg = EmbeddingConfig(ccfg.field_vocab_sizes, 16)
    eng = engines.SplitEngine(emb_cfg)
    fused = engines.FusedGatherEngine(emb_cfg)
    params = eng.init(torch.Generator().manual_seed(0), "meta")
    ids = torch.from_numpy(synthetic_criteo(16384, ccfg, start_row=555)[
        "ids"].astype(np.int64)).to(dev)
    gen = torch.Generator().manual_seed(99)
    cases = []   # (label, ids, grads, rows, timed)
    for name, _, fields, offsets in eng._index_tensors(dev):
        gids = (ids.index_select(1, fields) + offsets).reshape(-1)
        rows = params[name].shape[0]
        g = torch.randn(gids.shape[0], 17, generator=gen).to(dev)
        cases.append((f"split {name} table B=16384", gids, g, rows, True))
    gids = (ids + torch.as_tensor(fused.offsets, device=dev)).reshape(-1)
    fused_case = None
    for label, w in (("fused table B=16384", 17), ("wide weights B=16384", 1)):
        g = torch.randn(gids.shape[0], w, generator=gen).to(dev)
        cases.append((label, gids, g, fused.v_pad, True))
        fused_case = fused_case or (gids, g, fused.v_pad)
    for w in (1, 8, 16, 17, 32, 33):
        g = torch.randn(RAGGED_N, w, generator=gen).to(dev)
        cases.append((f"ragged W={w}", torch.randint(
            0, 1000, (RAGGED_N,), generator=gen).to(dev), g, 1000, False))
    hot = (4096 * torch.rand(50_000, generator=gen) ** 2.2).long()
    hot[:3] = 4095
    cases.append(("power-of-two table, last row hit", hot.clamp_(max=4095)
                  .to(dev), torch.randn(50_000, 17, generator=gen).to(dev),
                  4096, False))
    wild = torch.randint(-50, 1050, (20_000,), generator=gen)
    wild[::7], wild[::11] = 2 ** 40, -(2 ** 40)
    for w in (1, 17):
        cases.append((f"ids out of range W={w}", wild.to(dev),
                      torch.randn(20_000, w, generator=gen).to(dev), 1000,
                      False))
    g = torch.randn(409_600, 17, generator=gen).to(dev)
    cases.append(("one id", torch.zeros(409_600, dtype=torch.int64,
                                        device=dev), g, 4096, False))
    cases.append(("N=0", torch.zeros(0, dtype=torch.int64, device=dev),
                  torch.zeros(0, 17, device=dev), 4096, False))

    max_abs, shapes = 0.0, {}
    for label, gids, g, rows, timed in cases:
        got = ss.segment_sum(gids, g, rows)
        keep = (gids >= 0) & (gids < rows)     # the kernel drops the rest
        ref = ss.segment_sum_reference(gids[keep], g[keep], rows)
        scale = ss.segment_sum_reference(gids[keep], g[keep].abs(), rows)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= 1e-5 * scale + 1e-6).all())
        max_abs = max(max_abs, err.max().item() if err.numel() else 0.0)
        same = torch.equal(got, ss.segment_sum(gids, g, rows))
        uniq = int(torch.unique(gids).numel())
        line = (f"segment sum {label}: N={gids.shape[0]} rows={rows} "
                f"W={g.shape[1]} unique={uniq} max_abs_err="
                f"{err.max().item() if err.numel() else 0.0:.3e} "
                f"bitwise_repeat={same}")
        if timed:
            w = g.shape[1]

            def kern():
                return ss.segment_sum(gids, g, rows)

            def plain():
                return ss.segment_sum_reference(gids, g, rows)

            buf = torch.zeros_like(got)

            def index_add():
                return buf.index_add_(0, gids, g)

            def zeros_index_add():
                return torch.zeros((rows, w), device=dev).index_add_(
                    0, gids, g)

            b2b_ms, b2b_plain_ms = _timed_pair(kern, plain, 50)
            t = [_graph_ms(f) for f in (plain, kern, kern, plain)]
            k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            lib_ms = _graph_ms(index_add)
            whole_ms = _graph_ms(zeros_index_add)
            lib_b2b_ms = _cuda_ms(index_add, 50)
            whole_b2b_ms = _cuda_ms(zeros_index_add, 50)
            b_ms, b_by = _bound(_segment_sum_bytes(gids.shape[0], w, rows),
                                gids.shape[0] * w)
            parts = _device_breakdown(kern)
            shapes[label] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "zeros_index_add_ms": whole_ms, "bound_ms": b_ms,
                "bound_by": b_by, "back_to_back_ms": b2b_ms,
                "back_to_back_plain_ms": b2b_plain_ms,
                "back_to_back_index_add_ms": lib_b2b_ms,
                "back_to_back_zeros_index_add_ms": whole_b2b_ms,
                "breakdown": [[k, round(ms, 5), n] for k, ms, n in parts]}
            line += (f"\n  device (CUDA graph): kernel_ms={k_ms:.4f} "
                     f"plain_ms={p_ms:.4f} index_add_ms={lib_ms:.4f} "
                     f"zeros_index_add_ms={whole_ms:.4f} bound_ms="
                     f"{b_ms:.4f}\n  back to back: kernel_ms={b2b_ms:.4f} "
                     f"plain_ms={b2b_plain_ms:.4f} index_add_ms="
                     f"{lib_b2b_ms:.4f} zeros_index_add_ms="
                     f"{whole_b2b_ms:.4f}\n  per call on the device: "
                     + "; ".join(f"{k} {ms:.4f} ms x{n:g}"
                                 for k, ms, n in parts))
        print(line, flush=True)
        _check(ok, f"segment-sum kernel disagrees with its plain version "
                   f"({label})")
        _check(same, f"segment-sum kernel not bitwise deterministic "
                     f"({label})")

    # the whole call captured in a CUDA graph and replayed on new gradients
    gids, g, rows = fused_case
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.segment_sum(gids, g, rows)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.segment_sum(gids, g, rows)
    g.copy_(torch.randn(g.shape, generator=gen))
    graph.replay()
    torch.cuda.synchronize()
    _check(torch.equal(out, ss.segment_sum(gids, g, rows)),
           "segment sum replayed in a CUDA graph differs from an eager call")
    print("segment sum fused table: captured in a CUDA graph, replayed on "
          "new gradients, bitwise equal to an eager call", flush=True)
    return dict(shapes["fused table B=16384"], max_abs_err=max_abs,
                shapes=shapes)


def row_gather_phase(rg, ccfg, dev) -> dict:
    """Row-gather kernel vs ``index_select`` on the card, bitwise; times at
    DIN's item table, the Criteo big table and the fused engine's table:
    device time per call in a CUDA graph (ms: the sum of the first two
    shapes; each under ``shapes``), and the host loop through the wrapper,
    which is what the eager path pays per call."""
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
    fused = engines.FusedGatherEngine(eng.cfg)
    cases.append(("Criteo fused table B=16384", fused.v_pad, 17,
                  (ids + torch.as_tensor(fused.offsets)).reshape(-1), True))
    cases += [("ragged", 1000, 17,
               torch.randint(0, 1000, (RAGGED_N,), generator=gen), False),
              ("W=1", 300, 1, torch.randint(0, 300, (1000,), generator=gen),
               False),
              ("N=0", 64, 32, torch.zeros(0, dtype=torch.int64), False)]
    max_abs, timed_shapes = 0.0, {}
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
            # ids read, the rows they name read once, the output written
            n = gids.shape[0]
            b_ms, _ = _bound(8 * n + 4 * w * (
                int(torch.unique(gids).numel()) + n), 0)
            timed_shapes[label] = {"ms": k_ms, "plain_ms": p_ms,
                                   "library_ms": p_ms, "bound_ms": b_ms,
                                   "bound_by": "bytes", "host_ms": hk_ms,
                                   "host_plain_ms": hp_ms}
            line += (f" device: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                     f"bound_ms={b_ms:.4f}; host loop: wrapper_ms="
                     f"{hk_ms:.4f} plain_ms={hp_ms:.4f}")
        print(line, flush=True)
        _check(torch.equal(got, ref), f"row-gather kernel differs from "
                                      f"index_select ({label})")
    # the line's numbers: DIN's item table plus the Criteo big table, as in
    # earlier runs; the plain version is the library call, index_select
    both = [timed_shapes["DIN item table"],
            timed_shapes["Criteo big table B=16384"]]
    out = {k: sum(t[k] for t in both)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return dict(out, max_abs_err=max_abs, bound_by="bytes",
                shapes=timed_shapes)


def reshape_probe_phase(rp, dev) -> dict:
    """The reshape probes at VP = 837,632, W = 17: each entry point once
    (the launches counted), then bitwise against the plain version there
    and at a ragged length, timed in the order plain, kernel, kernel,
    plain as a host loop through the wrapper and as device time in a CUDA
    graph, beside ``torch.mul(x, 2.0)``. → per entry point its numbers."""
    gen = torch.Generator().manual_seed(17)
    flat = torch.randn(PROBE_ROWS * PROBE_W, generator=gen).to(dev)
    x2 = flat.view(PROBE_ROWS, PROBE_W)
    torch.cuda.synchronize()
    rp.VIA_RESHAPE_LAUNCHES = rp.VIA_2D_LAUNCHES = 0   # the path starts
    outs = {"flat": rp.via_reshape(flat, PROBE_W), "2d": rp.via_2d(x2)}
    torch.cuda.synchronize()
    launches = {"flat": rp.VIA_RESHAPE_LAUNCHES,
                "2d": rp.VIA_2D_LAUNCHES}                # ... and ends here
    _check(launches == {"flat": 1, "2d": 1},
           f"reshape probe launches {launches}, want one each")
    want = rp.reshape_probe_reference(flat, PROBE_W)
    ragged = flat[1:1 + 1001 * PROBE_W]      # ragged and 4 bytes off
    max_abs = 0.0
    for label, got, ref in [
            ("flat", outs["flat"], want), ("2d", outs["2d"], want),
            ("flat ragged", rp.via_reshape(ragged, PROBE_W),
             rp.reshape_probe_reference(ragged, PROBE_W)),
            ("2d ragged", rp.via_2d(flat[:1001 * PROBE_W].view(1001,
                                                               PROBE_W)),
             rp.reshape_probe_reference(flat[:1001 * PROBE_W], PROBE_W))]:
        torch.cuda.synchronize()
        max_abs = max(max_abs, (got - ref).abs().max().item())
        _check(torch.equal(got, ref), f"reshape probe {label} differs from "
                                      "its plain version")
    b_ms, b_by = _bound(2 * 4 * flat.numel(), flat.numel())
    out = torch.empty_like(x2)
    lib, res = rp._lib(), {}
    for label, fn, src, wrapper in (
            ("flat", "via_reshape", flat,
             lambda: rp.via_reshape(flat, PROBE_W)),
            ("2d", "via_2d", x2, lambda: rp.via_2d(x2))):

        def kern(fn=fn, src=src):
            err = getattr(lib, fn)(src.data_ptr(), out.data_ptr(),
                                   PROBE_ROWS, PROBE_W,
                                   torch.cuda.current_stream().cuda_stream)
            _check(err == 0, f"{fn} launch failed: {err}")

        def plain(src=src):
            return rp.reshape_probe_reference(src, PROBE_W)

        def library(src=src):
            torch.mul(src, 2.0, out=out.view(src.shape))

        hk_ms, hp_ms = _timed_pair(wrapper, plain, 50)
        t = [_graph_ms(f) for f in (plain, kern, kern, plain)]
        k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        lib_ms = _graph_ms(library)
        res[label] = {"launches": launches[label], "max_abs_err": max_abs,
                      "ms": k_ms,
                      "plain_ms": p_ms, "library_ms": lib_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "host_ms": hk_ms, "host_plain_ms": hp_ms}
        print(f"reshape probe {fn} VP={PROBE_ROWS} W={PROBE_W}: bitwise; "
              f"device: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"torch.mul_ms={lib_ms:.4f} bound_ms={b_ms:.4f}; host loop: "
              f"wrapper_ms={hk_ms:.4f} plain_ms={hp_ms:.4f}", flush=True)
    return res


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


def _latency(fn, n: int) -> list[float]:
    """Wall ms of ``n`` calls of ``fn`` (each ends on the host)."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def _p50_p99(lat: list[float]) -> tuple[float, float]:
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def _predict_pairs(sv, eager, requests: dict) -> dict:
    """In-process predict ms, graphed (``sv``) against eager, in
    GRAPH_PAIRS alternating pairs of LATENCY_REQUESTS calls a batch →
    {batch: {mode: [(p50, p99) of each pair]}}."""
    out = {b: {"graphed": [], "eager": []} for b in requests}
    for pair in range(GRAPH_PAIRS):
        for mode in (("eager", "graphed") if pair % 2 == 0
                     else ("graphed", "eager")):
            which = sv if mode == "graphed" else eager
            for b, feats in requests.items():
                out[b][mode].append(_p50_p99(_latency(
                    lambda: which.predict(feats), LATENCY_REQUESTS)))
    return out


def _profile_predicts(sv, feats, calls: int = 10) -> dict:
    """``calls`` predicts under ``torch.profiler`` → the trace's numbers a
    predict (`profile_step.trace_numbers`)."""
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.tools.profile_step import trace_numbers

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sv.predict(feats)
        torch.cuda.synchronize()
    return trace_numbers(prof, calls)


def serving_phase(export_dir: str, requests: dict, bad: dict, name: str,
                  counters: dict, per_request: dict,
                  profile_batch: int | None = None) -> dict:
    """Serving on the card against the CPU servable. `Servable.warmup`
    captures one CUDA graph a bucket; each request's graphed answer is
    bitwise the eager answer (``graphed=False``) at the same padded shape.
    Then, one request at a time, REST (JSON, NPZ1, RAW1) and the socket
    front end (RAW1), each request adding ``per_request[k]`` launches to
    counter ``k`` under replay; ``bad`` (an id out of range) gets a 400 and
    an error frame, launches nothing, and both fronts keep answering;
    then the in-process predict ms, graphed against eager, in alternating
    pairs, and (at ``profile_batch``) the host's launch calls and the
    device's busy ms a predict under ``torch.profiler``. → p50 ms per
    batch of each front, launches per counter over the served requests,
    request count, predict timings and profiles."""
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable
    from recsys_tpu_torch.serve.fastsock import SocketClient, SocketServer
    from recsys_tpu_torch.serve.server import make_rest_server

    sv = Servable(export_dir, device="cuda")
    eager = Servable(export_dir, device="cuda", graphed=False)
    sv_cpu = Servable(export_dir, device="cpu")
    _check(sv.graphed and not eager.graphed, f"{name}: graphed by default")
    sv.warmup()
    eager.warmup()
    _check(sv.captures == len(sv.buckets),
           f"{name}: warmup took {sv.captures} captures for buckets "
           f"{sv.buckets}")
    refs = {b: sv_cpu.predict(f) for b, f in requests.items()}
    for b, feats in requests.items():
        got, want = sv.predict(feats), eager.predict(feats)
        _check(np.array_equal(got, want), f"{name} batch {b}: graphed != "
               f"eager by {float(np.abs(got - want).max())}")
        err = float(np.abs(got - refs[b]).max())
        _check(err <= TOL, f"{name} batch {b} graphed: |card - cpu| = {err}")
    _check(sv.captures == len(sv.buckets),
           f"{name}: a request after the warm-up captured")
    print(f"{name}: warmup captured {sv.captures} bucket graphs "
          f"{sv.buckets}; each batch of {list(requests)} graphed bitwise "
          f"equal to eager at its padded shape, within {TOL} of the CPU",
          flush=True)
    srv, batcher = make_rest_server(sv, 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    sock = SocketServer(sv, 0, batcher)
    sock.start()
    conn = SocketClient(sock.port)
    p50, sock_p50 = {}, {}
    try:
        for feats in requests.values():                    # warm up
            client.rest_send(port, client.prepare_body(feats, "raw"))
            conn.send(client.prepare_body(feats, "raw"))
        _zero(counters)                  # the serving path starts here
        n_req = 0

        def served(b, front, fmt, send):
            nonlocal n_req
            before = _read(counters)
            t0 = time.perf_counter()
            got = send()
            dt = (time.perf_counter() - t0) * 1e3
            n_req += 1
            after = _read(counters)
            delta = {k: after[k] - before[k] for k in counters}
            _check(delta == per_request,
                   f"{name} batch {b} {front} {fmt}: kernel launches "
                   f"{delta}, want {per_request}")
            _check(got.shape == (b,) and bool(np.isfinite(got).all()),
                   f"{name} batch {b} {front} {fmt}: answer shape "
                   f"{got.shape} or values")
            err = float(np.abs(got - refs[b]).max())
            _check(err <= TOL, f"{name} batch {b} {front} {fmt}: |card - "
                               f"cpu| = {err}")
            return dt

        for b, feats in requests.items():
            bodies = {fmt: client.prepare_body(feats, fmt)
                      for fmt in ("json", "npz", "raw")}
            lat = [served(b, "REST", fmt,
                          lambda fmt=fmt: client.rest_send(port, bodies[fmt],
                                                           name))
                   for fmt in ["json", "npz"] + ["raw"] * LATENCY_REQUESTS]
            lat = lat[2:]
            slat = [served(b, "socket", "raw",
                           lambda: conn.send(bodies["raw"]))
                    for _ in range(LATENCY_REQUESTS)]
            p50[b], sock_p50[b] = _p50_p99(lat)[0], _p50_p99(slat)[0]
            print(f"{name} served batch {b}: REST RAW1/JSON/NPZ1 and socket "
                  f"RAW1 within {TOL} of the CPU run; probs mean "
                  f"{refs[b].mean():.4f} std {refs[b].std():.4f}; REST p50 "
                  f"{p50[b]:.3f} ms p99 {_p50_p99(lat)[1]:.3f} ms, socket "
                  f"p50 {sock_p50[b]:.3f} ms p99 {_p50_p99(slat)[1]:.3f} ms "
                  f"over {len(lat)} RAW1 requests each", flush=True)
            _check(b == 1 or float(refs[b].std()) > 1e-3,
                   f"{name} batch {b}: probabilities do not vary; the check "
                   "is void")
        launches = _read(counters)       # the serving path ends here
        _check(all(launches[k] == per_request[k] * n_req for k in counters),
               f"{name}: {launches} kernel launches for {n_req} requests")
        body = client.prepare_body(bad, "raw")
        try:
            client.rest_send(port, body, name)
            _check(False, f"{name}: a request with an id out of range was "
                          "answered")
        except urllib.error.HTTPError as e:
            _check(e.code == 400, f"{name}: bad request got HTTP {e.code}")
        try:
            conn.send(body)
            _check(False, f"{name}: the socket answered an id out of range")
        except RuntimeError as e:
            _check("ValueError" in str(e), f"{name}: socket error {e}")
        _check(_read(counters) == launches,
               f"{name}: the rejected request launched a kernel")
        b, feats = next(iter(requests.items()))
        for got in (client.rest_send(port, client.prepare_body(feats, "json"),
                                     name),
                    conn.send(client.prepare_body(feats, "npz"))):
            _check(float(np.abs(got - refs[b]).max()) <= TOL,
                   f"{name}: a front did not recover from a bad request")
        print(f"{name}: an id out of range got HTTP 400, an error frame and "
              "no launch; both fronts answered the next request", flush=True)
    finally:
        conn.close()
        sock.shutdown()
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        thread.join(10)
    timing = _predict_pairs(sv, eager, requests)

    def pairs(ms):
        return [(round(x, 4), round(y, 4)) for x, y in ms]

    print(f"{name} in-process predict ms (p50, p99) graphed vs eager, "
          f"{GRAPH_PAIRS} alternating pairs: " + "; ".join(
              f"batch {b}: graphed {pairs(t['graphed'])} eager "
              f"{pairs(t['eager'])}" for b, t in timing.items()), flush=True)
    profiles = {}
    if profile_batch is not None:
        for mode, which in (("graphed", sv), ("eager", eager)):
            prof = _profile_predicts(which, requests[profile_batch])
            ms = float(np.median([x for x, _ in
                                  timing[profile_batch][mode]]))
            prof["predict_ms"] = ms
            prof["device_idle_share"] = 1.0 - prof[
                "device_busy_ms_per_step"] / ms
            profiles[mode] = prof
            print(f"{name} batch {profile_batch} {mode} predict profile: "
                  f"{prof['launch_calls_per_step']:.1f} kernel launch calls "
                  f"and {prof['graph_launches_per_step']:.1f} graph launches "
                  f"a predict, {prof['device_ops_per_step']:.1f} device ops, "
                  f"busy {prof['device_busy_ms_per_step']:.4f} ms of the "
                  f"p50 {ms:.4f} ms: idle share "
                  f"{prof['device_idle_share']:.3f}; top "
                  f"{prof['top'][:3]}", flush=True)
    return {"launches": launches, "p50_ms": p50, "socket_p50_ms": sock_p50,
            "requests": n_req, "predict_ms": timing, "profiles": profiles}


def race_phase(export_dir: str, pool: list) -> dict:
    """8 client threads, 50 REST requests each, drawn from ``pool``
    (mixed batches, a few of 3,000 rows, so that coalesced groups pass the
    largest bucket and capture while serving): every answer within TOL of
    its own request's CPU answer. → the captures the run took and the
    largest coalesced group."""
    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable
    from recsys_tpu_torch.serve.server import make_rest_server

    sv = Servable(export_dir, device="cuda")
    sv.warmup()
    warm = sv.captures
    cpu = Servable(export_dir, device="cpu")
    refs = [cpu.predict(f) for f in pool]
    bodies = [client.prepare_body(f, "raw") for f in pool]
    srv, batcher = make_rest_server(sv, 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    errors, worst = [], [0.0]
    start = threading.Barrier(8)

    def client_thread(t):
        try:
            rng = np.random.default_rng(t)
            start.wait(60)
            for _ in range(50):
                i = int(rng.integers(len(pool)))
                got = client.rest_send(port, bodies[i])
                err = float(np.abs(got - refs[i]).max())
                worst[0] = max(worst[0], err)
                if got.shape != refs[i].shape or err > TOL:
                    errors.append(f"request {i}: shape {got.shape}, "
                                  f"|card - cpu| = {err}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client_thread, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        _check(not any(t.is_alive() for t in threads), "race: a client hung")
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop()
        thread.join(10)
    secs = time.perf_counter() - t0
    _check(not errors, f"race: {len(errors)} wrong answers, first "
                       f"{errors[:3]}")
    out = {"captures": sv.captures - warm,
           "largest_group": batcher.largest_group, "seconds": secs,
           "max_abs_err": worst[0]}
    print(f"race: 8 threads x 50 REST requests of mixed batches, every "
          f"answer within {TOL} of its CPU answer (max {worst[0]:.2e}) in "
          f"{secs:.1f} s; {out['captures']} captures while serving, largest "
          f"coalesced group {out['largest_group']} rows", flush=True)
    return out


def numpy_engine_phase(export_dir: str, name: str, requests: dict) -> dict:
    """The NumPy engine on the card's host against the CPU servable
    (``rtol 2e-4, atol 2e-6``) at every batch; → its p50 ms at batches 1
    and 200."""
    from recsys_tpu_torch.serve.export import Servable

    npsv = Servable(export_dir, device="cpu", engine="numpy")
    cpu = Servable(export_dir, device="cpu")
    for b, feats in requests.items():
        got, want = npsv.predict(feats), cpu.predict(feats)
        _check(got.shape == (b,) and bool(np.allclose(got, want, rtol=2e-4,
                                                      atol=2e-6)),
               f"{name} numpy engine batch {b}: |numpy - cpu| = "
               f"{float(np.abs(got - want).max())}")
    p50 = {b: _p50_p99(_latency(lambda f=requests[b]: npsv.predict(f),
                                LATENCY_REQUESTS * 5))[0]
           for b in (1, 200) if b in requests}
    print(f"{name} numpy engine: within rtol 2e-4 atol 2e-6 of the CPU "
          f"servable at batches {list(requests)}; p50 "
          + ", ".join(f"batch {b}: {ms:.4f} ms" for b, ms in p50.items()),
          flush=True)
    return p50


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
    command line answers over REST and the socket as the CPU servable
    does; gRPC too where ``grpcio`` is installed, and where it is not, the
    command says that it does not serve gRPC."""
    import importlib.util

    from recsys_tpu_torch.serve import client
    from recsys_tpu_torch.serve.export import Servable
    from recsys_tpu_torch.serve.fastsock import SocketClient

    said = []

    def ports_of(line):
        said.append(line)
        m = re.search(r"REST:(\d+) gRPC:(\d+|none) socket:(\d+)", line)
        return m.groups() if m else None

    proc, (rest, grpc_port, sock) = _run_cli(
        module, ["serve", f"--export_dir={export_dir}", "--device=cuda",
                 "--port=0"], 300, until=ports_of)
    try:
        body = client.prepare_body(feats, "raw")
        ref = Servable(export_dir, device="cpu").predict(feats)
        with SocketClient(int(sock)) as conn:
            answers = {"REST": client.rest_send(int(rest), body),
                       "socket": conn.send(body)}
        if importlib.util.find_spec("grpc") is None:
            _check(grpc_port == "none" and any(
                "gRPC is not served" in line for line in said),
                f"{module} serve: no grpcio here, yet gRPC:{grpc_port}")
        else:
            answers["gRPC"] = client.grpc_send(
                client.make_grpc_stub(int(grpc_port)), body)
        for front, got in answers.items():
            err = float(np.abs(got - ref).max())
            _check(err <= TOL, f"{module} serve {front}: |card - cpu| = "
                               f"{err}")
        print(f"{module} serve: REST on port {rest}, socket on {sock}, gRPC "
              f"{grpc_port}: batch {len(ref)} within {TOL} of the CPU run "
              f"over {sorted(answers)}", flush=True)
    finally:
        _stop(proc)


def _event_records(path: str) -> int:
    """The records of a TensorBoard event file, each one's length and
    payload checked against its masked crc32c."""
    import struct

    from recsys_tpu_torch.train.tb_events import _masked_crc

    n = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return n
            (crc,) = struct.unpack("<I", f.read(4))
            _check(crc == _masked_crc(head), f"{path}: bad length crc")
            payload = f.read(struct.unpack("<Q", head)[0])
            (crc,) = struct.unpack("<I", f.read(4))
            _check(crc == _masked_crc(payload), f"{path}: bad payload crc")
            n += 1


def check_run_outputs(model_dir: str, eval_steps: list[int],
                      tags: list[tuple[int, set]]) -> None:
    """A training run's outputs: ``best/`` (the step of the highest eval
    AUC), ``scalars.jsonl`` whose lines hold ``tags`` ((step, tag set) a
    line), and one event file with a record for each line."""
    import json as json_

    from recsys_tpu_torch.train.summaries import read_scalars

    recs = read_scalars(model_dir)
    got = [(r["step"], set(r) - {"step", "wall_time"}) for r in recs]
    _check(got == tags, f"{model_dir}: scalars {got}, want {tags}")
    aucs = {r["step"]: r["eval_auc"] for r in recs if "eval_auc" in r}
    _check(sorted(aucs) == eval_steps, f"eval AUC at {sorted(aucs)}")
    with open(os.path.join(model_dir, "best", "meta.json")) as f:
        best = json_.load(f)
    _check(best["metric"] == max(aucs.values())
           and aucs[best["step"]] == best["metric"],
           f"best/ is step {best['step']} at {best['metric']}, evals {aucs}")
    events = [n for n in os.listdir(model_dir)
              if n.startswith("events.out.tfevents.")]
    _check(len(events) == 1, f"event files {events}")
    records = _event_records(os.path.join(model_dir, events[0]))
    _check(records == 1 + len(recs), f"{records} event records for "
                                     f"{len(recs)} scalar lines")


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


def _three_steps_match(name, ccfg, mcfg, data, batch_size, dev,
                       lr: float = 1e-3) -> float:
    """3 steps at dropout 0 from one state on one [3, B] index matrix, on the
    card and on the CPU, with the optimizer the model declares at ``lr``;
    → max |Δ| over every parameter."""
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
        ts, tx = TS.create_train_state(model, 11, lr, d)
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


def _grads_match(name, ccfg, mcfg, data, batch_size, dev) -> float:
    """Every gradient of one batch's loss at dropout 0 from one seeded
    state, on the card and on the CPU; → the largest difference relative
    to its leaf's largest CPU gradient (absolute for a leaf whose gradient
    is zero), after checking it is within 1e-4."""
    import dataclasses

    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import train_state as TS

    model = make_model(name, ccfg, dataclasses.replace(mcfg, dropout=0.0))
    out = []
    for d in ("cpu", dev):
        ts, _ = TS.create_train_state(model, 11, 1e-3, d)
        batch = {k: torch.from_numpy(v[:batch_size]).to(d)
                 for k, v in data.items()}
        batch["ids"] = batch["ids"].long()
        _, _, g = TS.loss_and_grads(model, ts.params, ts.model_state, batch)
        out.append([x.cpu() for x in tree.leaves(g)])
    worst = 0.0
    for g_cpu, g_dev in zip(*out):
        diff = float((g_dev - g_cpu).abs().max())
        scale = float(g_cpu.abs().max())    # 0 for a leaf the model skips
        worst = max(worst, diff / scale if scale > 0 else diff)
    _check(worst <= 1e-4, f"{name}: gradients on the card differ from the "
                          f"CPU's by {worst} of their largest")
    return worst


def train_phase(name, ccfg, mcfg, batch_size, dev, cin_kernel, ss, rg, *,
                lr: float = 1e-3, reads: int = 2,
                match: str = "steps") -> dict:
    """Train full-width ``name`` on the card through the devgen fast path
    with the optimizer the model declares at ``lr``; each step reads
    ``reads`` tables. Then 3 steps (``match='steps'``) or one batch's
    gradients (``'grads'``) on the card are held against the CPU. →
    counts and numbers of the main path's run."""
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    label = name + (" (fused engine)" if mcfg.emb_engine == "fused" else "")
    model = make_model(name, ccfg, mcfg)
    data = synthetic_criteo(16 * batch_size, ccfg)
    eval_data = synthetic_criteo(4 * batch_size, ccfg, start_row=10 ** 8)
    staged = fast.stage_dataset(data, dev)
    staged_eval = fast.stage_dataset(eval_data, dev)
    ts, tx = TS.create_train_state(model, 0, lr, dev)
    auc0 = _eval_auc(model, ts, staged_eval, batch_size)
    step_fn = fast.make_scanned_train_step_devgen(
        model, tx, len(data["label"]), batch_size)

    torch.cuda.synchronize()
    ss.LAUNCHES = rg.LAUNCHES = cin_kernel.LAUNCHES = 0
    cin_kernel.BWD_LAUNCHES = 0
    losses, t_calls = [], []
    for c in range(TRAIN_STEPS // K):        # the training path starts here
        t0 = time.perf_counter()
        ts, loss = step_fn(ts, staged, K, c * K)
        losses.append(float(loss))           # one host read per call
        t_calls.append(time.perf_counter() - t0)
    counts = {"segment_sum": ss.LAUNCHES, "row_gather": rg.LAUNCHES,
              "cin_fwd": cin_kernel.LAUNCHES,
              "cin_bwd": cin_kernel.BWD_LAUNCHES}   # ... and ends here
    steps = K * len(losses)
    # the first call warms up the allocator and cuBLAS: rate over the rest
    ex_s = batch_size * K * (len(t_calls) - 1) / sum(t_calls[1:])
    auc1 = _eval_auc(model, ts, staged_eval, batch_size)
    print(f"{label} training at batch {batch_size}: {steps} steps, mean loss "
          f"per call {['%.5f' % l for l in losses]}, eval AUC {auc0:.4f} -> "
          f"{auc1:.4f} on {len(eval_data['label'])} held-out rows, "
          f"{ex_s:.1f} ex/s (calls 2-{len(t_calls)}), launches {counts}",
          flush=True)
    _check(all(np.isfinite(losses)), f"{label}: loss {losses}")
    _check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    _check(counts["segment_sum"] == reads * steps and
           counts["row_gather"] == reads * steps,
           f"{label}: segment-sum and row-gather launches {counts} for "
           f"{steps} steps, want {reads * steps} each ({reads} table reads "
           "per step)")
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
           f"{label}: eval AUC {auc1} after training, {auc0} before")
    if match == "steps":
        diff = _three_steps_match(name, ccfg, mcfg, data, batch_size, dev,
                                  lr)
        print(f"{label}: 3 steps at dropout 0 on the card match the CPU: "
              f"max |param diff| {diff:.3e} (tolerance {STEP_TOL})",
              flush=True)
    else:
        rel = _grads_match(name, ccfg, mcfg, data, batch_size, dev)
        print(f"{label}: every gradient at dropout 0 on the card matches "
              f"the CPU's: max |diff| {rel:.3e} of its leaf's largest "
              "(tolerance 1e-4)", flush=True)
    return {"counts": counts, "ex_s": ex_s, "auc": (auc0, auc1),
            "losses": losses}


def graph_vs_eager_phase(name, ccfg, mcfg, batch_size, dev, *,
                         lr: float = 1e-3) -> dict:
    """The devgen K-step call replaying one captured CUDA graph a step
    against the same call run eagerly, kernel by kernel from Python, at
    full width: two train states from one seed, one call of K steps each,
    then every parameter, BN stat and optimizer leaf held equal (bitwise:
    the same kernels on the same inputs, and each replay draws what the
    eager step draws); GRAPH_PAIRS pairs of timed calls, the two modes in
    alternating order (ex/s of each call); one call of 10 steps of each
    under torch.profiler (host launch calls a step); the leaves held equal
    again at the end. → numbers of the run."""
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.tools.profile_step import profile_call
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    model = make_model(name, ccfg, mcfg)
    data = synthetic_criteo(16 * batch_size, ccfg)
    staged = fast.stage_dataset(data, dev)
    runs = {}
    for mode in ("eager", "graphed"):
        ts, tx = TS.create_train_state(model, 0, lr, dev)
        fn = fast.make_scanned_train_step_devgen(
            model, tx, len(data["label"]), batch_size,
            graphed=mode == "graphed")
        ts, loss = fn(ts, staged, K, 0)
        runs[mode] = {"ts": ts, "fn": fn, "done": K, "loss": float(loss),
                      "ex_s": []}

    def max_diff() -> float:
        leaves = [tree.leaves((r["ts"].params, r["ts"].model_state,
                               r["ts"].opt_state)) for r in runs.values()]
        return max(float((a - b).abs().max()) for a, b in zip(*leaves))

    first = max_diff()
    _check(first <= GRAPH_TOL and
           runs["eager"]["loss"] == runs["graphed"]["loss"],
           f"{name}: after {K} steps graphed and eager differ by {first} "
           f"(tolerance {GRAPH_TOL}), losses {runs['eager']['loss']} and "
           f"{runs['graphed']['loss']}")
    for p in range(GRAPH_PAIRS):
        for mode in (("eager", "graphed") if p % 2 == 0
                     else ("graphed", "eager")):
            r = runs[mode]
            t0 = time.perf_counter()
            r["ts"], loss = r["fn"](r["ts"], staged, K, r["done"])
            float(loss)                       # waits for the last step
            r["ex_s"].append(batch_size * K / (time.perf_counter() - t0))
            r["done"] += K
    for r in runs.values():
        r["ts"], r["prof"] = profile_call(r["fn"], r["ts"], staged,
                                          r["done"])
    last = max_diff()
    _check(last <= GRAPH_TOL, f"{name}: after {runs['eager']['done'] + 10} "
                              f"steps graphed and eager differ by {last}")
    out = {"max_abs_diff": (first, last)}
    for mode, r in runs.items():
        out[mode] = {"ex_s": r["ex_s"],
                     "launch_calls_per_step": r["prof"][
                         "launch_calls_per_step"],
                     "graph_launches_per_step": r["prof"][
                         "graph_launches_per_step"],
                     "busy_ms_per_step": r["prof"][
                         "device_busy_ms_per_step"]}
    print(f"{name} at batch {batch_size}, graphed vs eager: parameters, BN "
          f"and optimizer state equal after {K} steps and after "
          f"{runs['eager']['done'] + 10} (max |diff| {first}, {last}; "
          f"tolerance {GRAPH_TOL}); ex/s in alternating pairs: eager "
          f"{['%.0f' % x for x in out['eager']['ex_s']]}, graphed "
          f"{['%.0f' % x for x in out['graphed']['ex_s']]}; host launch "
          "calls a step (cudaLaunchKernel + cudaGraphLaunch): eager "
          f"{out['eager']['launch_calls_per_step']:.1f} + "
          f"{out['eager']['graph_launches_per_step']:.1f}, graphed "
          f"{out['graphed']['launch_calls_per_step']:.1f} + "
          f"{out['graphed']['graph_launches_per_step']:.1f}; device busy "
          f"{out['eager']['busy_ms_per_step']:.3f} / "
          f"{out['graphed']['busy_ms_per_step']:.3f} ms a step", flush=True)
    _check(round(out["graphed"]["graph_launches_per_step"], 6) == 1.0,
           f"{name}: {out['graphed']['graph_launches_per_step']} graph "
           "launches a step, want 1")
    return out


def train_cli_phase(ccfg, model_flags=(("deepfm", "split"), ("dcn", "fused"))
                    ) -> None:
    """``train_ctr train --device=cuda`` on synthetic shards, once for each
    (model, engine) of ``model_flags``."""
    from recsys_tpu_torch.data.criteo import write_synthetic_shards

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = f"{tmp}/data"
        write_synthetic_shards(data_dir, 10 * 32768, 10, ccfg)
        for name, engine in model_flags:
            model_dir = f"{tmp}/model_{name}_{engine}"
            code, out = _run_cli(
                "train_ctr",
                ["train", f"--model.name={name}",
                 f"--model.emb_engine={engine}", "--device=cuda",
                 f"--data_dir={data_dir}", f"--train.model_dir={model_dir}",
                 "--train.batch_size=16384", "--train.num_steps=100",
                 "--train.eval_every_steps=50", "--train.eval_steps=2"], 600)
            _check(code == 0, f"train_ctr train {name} exited with {code}")
            m = re.search(r"'auc': ([0-9.]+)", out)
            _check(m is not None, f"train_ctr train {name} printed no eval "
                                  "AUC")
            ckpts = sorted(os.listdir(model_dir))
            _check("step_100" in ckpts, f"no checkpoint step_100 in {ckpts}")
            every = {"loss", "examples_per_sec", "eval_auc", "eval_logloss"}
            check_run_outputs(model_dir, [50, 100],
                              [(50, every), (100, every)])
            print(f"command-line training {name} ({engine} engine): eval AUC "
                  f"{m.group(1)}, model_dir {ckpts}: best/ is the best eval "
                  "AUC's step, scalars.jsonl and the event file hold loss, "
                  "examples_per_sec, eval_auc and eval_logloss at steps 50 "
                  "and 100", flush=True)


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
    _check(counts["segment_sum"] == 5 * DIN_STEPS,
           f"DIN: {counts['segment_sum']} segment-sum launches for "
           f"{DIN_STEPS} steps, want {5 * DIN_STEPS}")
    _check(counts["row_gather"] == 5 * (DIN_STEPS + n_eval),
           f"DIN: {counts['row_gather']} row-gather launches for "
           f"{DIN_STEPS} steps and {n_eval} eval batches, want "
           f"{5 * (DIN_STEPS + n_eval)}")
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
        log, evals = {"loss", "examples_per_sec"}, {"eval_auc",
                                                     "eval_logloss"}
        check_run_outputs(f"{tmp}/model", [50, 100],
                          [(50, log), (50, evals), (100, log), (100, evals)])
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


def _fed_runs(model, batches_fn, dev, label: str) -> dict:
    """The host-fed step (`fast.make_fed_train_step`) graphed, one replay a
    step, against the same step run eagerly from Python: two train states
    from one seed take the same FED_STEPS batches (``batches_fn()``, a
    fresh host iterator with the same batches each time, through
    `device_prefetch`), then every parameter, BN stat and optimizer leaf
    and every step's loss are held equal (tolerance GRAPH_TOL = 0); then
    GRAPH_PAIRS pairs of timed runs of FED_STEPS steps, the two modes in
    alternating order, each through its own prefetcher started one step
    before the window, with the share of the window the consumer waited on
    the prefetch queue. → numbers of the run."""
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.data.loader import device_prefetch
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    runs = {}
    for mode in ("eager", "graphed"):
        ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
        runs[mode] = {"ts": ts, "ex_s": [], "wait_share": [],
                      "step": fast.make_fed_train_step(
                          model, tx, graphed=mode == "graphed")}
    losses = {mode: [] for mode in runs}
    batches = device_prefetch(batches_fn(), dev)
    for i, batch in zip(range(FED_STEPS), batches):
        for mode, r in runs.items():
            losses[mode].append(r["step"](r["ts"], batch, i))
    batches.close()
    leaves = [tree.leaves((r["ts"].params, r["ts"].model_state,
                           r["ts"].opt_state)) for r in runs.values()]
    diff = max(float((a - b).abs().max()) for a, b in zip(*leaves))
    same = all(torch.equal(a, b) for a, b in zip(losses["eager"],
                                                 losses["graphed"]))
    _check(diff <= GRAPH_TOL and same,
           f"{label}: after {FED_STEPS} host-fed steps graphed and eager "
           f"differ by {diff} (tolerance {GRAPH_TOL}), losses equal: {same}")
    done = FED_STEPS
    for p in range(GRAPH_PAIRS):
        for mode in (("eager", "graphed") if p % 2 == 0
                     else ("graphed", "eager")):
            r = runs[mode]
            it = device_prefetch(batches_fn(), dev)
            float(r["step"](r["ts"], next(it), done))
            wait = 0.0
            t0 = time.perf_counter()
            for i in range(FED_STEPS):
                tw = time.perf_counter()
                batch = next(it)
                wait += time.perf_counter() - tw
                loss = r["step"](r["ts"], batch, done + 1 + i)
            float(loss)                       # waits for the last step
            wall = time.perf_counter() - t0
            it.close()
            b = len(batch["label"])
            r["ex_s"].append(b * FED_STEPS / wall)
            r["wait_share"].append(wait / wall)
        done += FED_STEPS + 1
    out = {"max_abs_diff": diff}
    for mode, r in runs.items():
        out[mode] = {"ex_s": r["ex_s"], "wait_share": r["wait_share"]}
    print(f"{label}, host-fed, graphed vs eager: parameters, BN and "
          f"optimizer state and every loss equal after {FED_STEPS} steps "
          f"(max |diff| {diff}; tolerance {GRAPH_TOL}); ex/s in alternating "
          f"pairs of {FED_STEPS} steps: eager "
          f"{['%.0f' % x for x in out['eager']['ex_s']]}, graphed "
          f"{['%.0f' % x for x in out['graphed']['ex_s']]}; share of the "
          "wall time the consumer waited on the prefetch queue: eager "
          f"{['%.4f' % x for x in out['eager']['wait_share']]}, graphed "
          f"{['%.4f' % x for x in out['graphed']['wait_share']]}",
          flush=True)
    return out


def streaming_phase(ccfg, dev, rg, ss) -> dict:
    """Full-width DeepFM (dim 16, DNN 100-100 with BN and dropout 0.5, Adam
    lr 1e-3) at batch 16384 streamed from STREAM_SHARDS npz shards of
    synthetic rows on local disk (and one more held out): STREAM_STEPS
    steps through ``loop.train_and_evaluate`` (`ShardSource`,
    `device_prefetch`, the graphed host-fed step); the loss must fall, the
    held-out AUC rise by AUC_MARGIN, each step launch the segment sum and
    the row gather twice (the row gather twice a batch of eval too); then
    the host-fed step graphed against eager (`_fed_runs`), and the fast
    path (the same rows on the device, K steps a call) timed on the same
    rows. → counts and numbers of the main path's run."""
    from recsys_tpu_torch.core.config import ModelConfig, TrainConfig
    from recsys_tpu_torch.data.criteo import write_synthetic_shards
    from recsys_tpu_torch.data.loader import ShardSource
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast, loop
    from recsys_tpu_torch.train import train_state as TS

    b = 16384
    model = make_model("deepfm", ccfg, ModelConfig())
    per_shard = STREAM_ROWS // STREAM_SHARDS
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_synthetic_shards(f"{tmp}/data",
                                       STREAM_ROWS + per_shard,
                                       STREAM_SHARDS + 1, ccfg)
        write_s = time.perf_counter() - t0
        train_paths, eval_paths = paths[:-1], paths[-1:]
        nbytes = sum(os.path.getsize(p) for p in train_paths)
        src = ShardSource(train_paths, b, seed=0, num_epochs=-1)
        n_eval = per_shard // b
        eval_fn = lambda: ShardSource(eval_paths, b,  # noqa: E731
                                      shuffle=False, num_epochs=1)
        cfg = TrainConfig(batch_size=b, learning_rate=1e-3,
                          eval_every_steps=STREAM_STEPS, log_every_steps=50,
                          save_checkpoints_steps=STREAM_STEPS,
                          eval_steps=n_eval, model_dir=f"{tmp}/model")
        ts0, _ = TS.create_train_state(model, cfg.seed, 1e-3, dev)
        auc0 = loop.evaluate(model, ts0.params, ts0.model_state, eval_fn(),
                             device=dev)["auc"]
        del ts0
        torch.cuda.synchronize()
        counters = {"segment_sum": ss, "row_gather": rg}
        _zero(counters)                  # the training path starts here
        m = loop.train_and_evaluate(model, iter(src), eval_fn, cfg,
                                    num_steps=STREAM_STEPS, device=dev,
                                    resume=False)
        counts = _read(counters)         # ... and ends here
        print(f"streaming DeepFM at batch {b}: {STREAM_STEPS} steps over "
              f"{STREAM_SHARDS} shards ({STREAM_ROWS} rows, {nbytes} bytes "
              f"of npz, written in {write_s:.1f} s), logged loss "
              f"{m['first_loss']:.5f} -> {m['final_loss']:.5f}, eval AUC "
              f"{auc0:.4f} -> {m['auc']:.4f} on {int(m['count'])} held-out "
              f"rows, {m['examples_per_sec']:.1f} ex/s (steps "
              f"{STREAM_STEPS - 49}-{STREAM_STEPS}), {m['train_seconds']:.2f}"
              f" s in all, launches {counts}", flush=True)
        _check(np.isfinite(m["first_loss"]) and np.isfinite(m["final_loss"])
               and m["final_loss"] < m["first_loss"],
               f"streaming DeepFM: loss {m['first_loss']} -> "
               f"{m['final_loss']}")
        _check(m["auc"] >= auc0 + AUC_MARGIN,
               f"streaming DeepFM: eval AUC {m['auc']} after training, "
               f"{auc0} before")
        _check(counts["segment_sum"] == 2 * STREAM_STEPS and
               counts["row_gather"] == 2 * (STREAM_STEPS + n_eval),
               f"streaming DeepFM: launches {counts} for {STREAM_STEPS} "
               f"steps and {n_eval} eval batches, want "
               f"{2 * STREAM_STEPS} segment sums and "
               f"{2 * (STREAM_STEPS + n_eval)} row gathers")
        fed = _fed_runs(model, lambda: iter(src), dev, "streaming DeepFM")
        pipe = _pipeline_rates(src, dev)

        parts = []
        for p in train_paths:
            with np.load(p) as z:
                parts.append(dict(z))
        staged = fast.stage_dataset(
            {k: np.concatenate([q[k] for q in parts]) for k in parts[0]},
            dev)
        del parts
        ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
        fn = fast.make_scanned_train_step_devgen(model, tx, STREAM_ROWS, b)
        ts, loss = fn(ts, staged, K, 0)           # the capture
        float(loss)
        fast_ex_s = []
        for c in range(GRAPH_PAIRS):
            t0 = time.perf_counter()
            ts, loss = fn(ts, staged, K, K * (c + 1))
            float(loss)
            fast_ex_s.append(b * K / (time.perf_counter() - t0))
        del staged, ts, fn
    print(f"streaming DeepFM against the fast path on the same rows (the "
          f"dataset on the device, {K} steps a call): fast path ex/s "
          f"{['%.0f' % x for x in fast_ex_s]}, streamed graphed "
          f"{['%.0f' % x for x in fed['graphed']['ex_s']]}", flush=True)
    return {"counts": counts, "ex_s": m["examples_per_sec"],
            "auc": (auc0, m["auc"]), "fed": fed, "fast_ex_s": fast_ex_s,
            "pipeline_rows_s": pipe}


def _pipeline_rates(src, dev) -> dict:
    """Rows/s of the input pipeline with no training step behind it, over
    FED_STEPS batches after one (the shards cached in ``src`` already):
    ``ShardSource`` alone on the host, and through ``device_prefetch`` to
    the card (the last copy waited for)."""
    from recsys_tpu_torch.data.loader import device_prefetch

    rates = {}
    for name in ("shard_source", "device_prefetch"):
        it = iter(src) if name == "shard_source" else device_prefetch(
            iter(src), dev)
        rows = len(next(it)["label"]) * FED_STEPS
        t0 = time.perf_counter()
        for _ in range(FED_STEPS):
            batch = next(it)
        torch.cuda.current_stream().synchronize()
        rates[name] = rows / (time.perf_counter() - t0)
        it.close()
        del batch
    print(f"input pipeline alone, {FED_STEPS} batches: ShardSource "
          f"{rates['shard_source']:.0f} rows/s on the host, through "
          f"device_prefetch {rates['device_prefetch']:.0f} rows/s to the "
          "card", flush=True)
    return rates


def din_fed_phase(train, dev) -> dict:
    """Full-width DIN's host-fed step graphed against eager (`_fed_runs`)
    on the batches ``train_din`` draws."""
    from recsys_tpu_torch.tools import train_din

    model, _ = _din_model(0.1)
    return _fed_runs(model, lambda: train_din.batch_iter(
        train, DIN_BATCHES[-1], seed=0), dev, "DIN")


def tsv_phase(ccfg) -> dict:
    """A raw Criteo-format TSV of TSV_ROWS synthetic lines → the native
    parser held against the pure-Python path on its first TSV_CHECK_ROWS
    rows → `preprocess_tsv` into shards → ``train_ctr train --streaming
    --device=cuda`` for 100 steps → ``train_ctr eval`` on the checkpoint
    it left."""
    from recsys_tpu_torch.data import criteo, native

    with tempfile.TemporaryDirectory() as tmp:
        tsv = f"{tmp}/day.tsv"
        t0 = time.perf_counter()
        criteo.write_synthetic_tsv(tsv, TSV_ROWS, seed=0)
        write_s = time.perf_counter() - t0
        _check(native.available(), "the native host library did not build "
                                   "or load")
        with open(tsv) as f:
            lines = [next(f) for _ in range(TSV_CHECK_ROWS)]
        labels, cont, cat, consumed = native.parse_criteo_bytes(
            "".join(lines).encode(), ccfg.cat_vocabs)
        want_labels, want_cont, want_cat = criteo.parse_tsv_chunk(lines)
        same = (consumed == len("".join(lines).encode())
                and np.array_equal(labels, want_labels)
                and np.array_equal(cont, want_cont, equal_nan=True)
                and np.array_equal(cat, criteo.hash_cat(want_cat, ccfg)))
        _check(same, "the native TSV parse differs from the pure-Python "
                     f"path on the first {TSV_CHECK_ROWS} rows")
        t0 = time.perf_counter()
        shards = criteo.preprocess_tsv(tsv, f"{tmp}/shards", ccfg,
                                       rows_per_shard=32_768)
        rows_s = TSV_ROWS / (time.perf_counter() - t0)
        print(f"TSV: {TSV_ROWS} rows written in {write_s:.1f} s; the native "
              f"parse equals the pure-Python path on the first "
              f"{TSV_CHECK_ROWS} rows; preprocess_tsv (two passes: the "
              f"means, then parse and shard) {rows_s:.0f} rows/s into "
              f"{len(shards)} shards", flush=True)
        flags = ["--device=cuda", f"--data_dir={tmp}/shards",
                 f"--train.model_dir={tmp}/model", "--train.batch_size=16384",
                 "--train.eval_steps=2"]
        code, out = _run_cli("train_ctr", [
            "train", "--streaming", "--train.num_steps=100",
            "--train.eval_every_steps=50", "--train.log_every_steps=50"]
            + flags, 600)
        _check(code == 0, f"train_ctr train --streaming exited with {code}")
        m = re.search(r"'auc': ([0-9.]+)", out)
        _check(m is not None, "train_ctr train --streaming printed no eval "
                              "AUC")
        ckpts = sorted(os.listdir(f"{tmp}/model"))
        _check("step_100" in ckpts, f"no checkpoint step_100 in {ckpts}")
        log, evals = {"loss", "examples_per_sec"}, {"eval_auc",
                                                     "eval_logloss"}
        check_run_outputs(f"{tmp}/model", [50, 100],
                          [(50, log), (50, evals), (100, log), (100, evals)])
        code, out = _run_cli("train_ctr", ["eval"] + flags, 600)
        _check(code == 0, f"train_ctr eval exited with {code}")
        e = re.search(r"'auc': ([0-9.]+).*'count': ([0-9.]+)", out)
        _check(e is not None and float(e.group(2)) > 0,
               "train_ctr eval printed no eval AUC and count")
    print(f"command-line streaming training on the preprocessed shards: "
          f"eval AUC {m.group(1)} (random labels: about 0.5), checkpoints "
          f"{ckpts}; train_ctr eval on it: AUC {e.group(1)} over "
          f"{e.group(2)} rows", flush=True)
    return {"rows_s": rows_s}


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
    from recsys_tpu_torch.ops import reshape_probe as rp
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

    sources = [cin_kernel.SOURCE, cin_kernel.BWD_SOURCE, ss.SOURCE, rg.SOURCE,
               rp.SOURCE]
    libs = cuda_build.build_all(sources)
    print(f"built {len(libs)} kernel sources in parallel in "
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
    probe = reshape_probe_phase(rp, dev)
    print(f"kernel phases ok [{card}]: CIN fwd {fwd['ms']:.4f} ms vs plain "
          f"{fwd['plain_ms']:.4f} ms ({fwd['graph_ms']:.4f} ms of device "
          f"time), CIN bwd {bwd['ms']:.4f} ms vs plain "
          f"{bwd['plain_ms']:.4f} ms ({bwd['graph_ms']:.4f} ms of device "
          "time) (three layers at B=4096); segment sum "
          f"{seg['ms']:.4f} ms vs plain {seg['plain_ms']:.4f} ms, index_add_ "
          f"{seg['library_ms']:.4f} ms (fused table at B=16384); row gather "
          f"{gat['ms']:.4f} ms vs index_select {gat['plain_ms']:.4f} ms of "
          "device time (DIN item table at B=1024 plus Criteo big table at "
          f"B=16384); reshape probes {probe['flat']['ms']:.4f} / "
          f"{probe['2d']['ms']:.4f} ms vs torch.mul "
          f"{probe['flat']['library_ms']:.4f} / "
          f"{probe['2d']['library_ms']:.4f} ms of device time", flush=True)

    served = {}
    for name, mcfg, per_request in (
            ("xdeepfm", xcfg, {"cin_fwd": 3, "row_gather": 2,
                               "segment_sum": 0}),
            ("dcn", ModelConfig(name="dcn"), {"cin_fwd": 0, "row_gather": 2,
                                              "segment_sum": 0})):
        model = make_model(name, ccfg, mcfg)
        params, state = randomize(*model.init(
            torch.Generator().manual_seed(0), "cpu"), seed=1)
        reqs = {}
        for i, b in enumerate(BATCHES):
            d = synthetic_criteo(b, ccfg, start_row=10_000 * i)
            reqs[b] = {"ids": d["ids"], "dense": d["dense"]}
        bad = {"ids": reqs[1]["ids"].copy(), "dense": reqs[1]["dense"]}
        bad["ids"][0, -1] = ccfg.field_vocab_sizes[-1]
        with tempfile.TemporaryDirectory() as export_dir:
            export_servable(export_dir, name, params, state, mcfg, ccfg)
            served[name] = serving_phase(
                export_dir, reqs, bad, name,
                {"cin_fwd": cin_kernel, "row_gather": rg, "segment_sum": ss},
                per_request, profile_batch=4096 if name == "xdeepfm" else None)
            served[name]["numpy_p50_ms"] = numpy_engine_phase(export_dir,
                                                              name, reqs)
            if name == "xdeepfm":
                rng = np.random.default_rng(5)
                sizes = [int(x) for x in rng.integers(1, 1025, 13)]
                pool = []
                for i, b in enumerate(sizes + [RACE_BIG] * 3):
                    d = synthetic_criteo(b, ccfg, start_row=50_000 + 4000 * i)
                    pool.append({"ids": d["ids"], "dense": d["dense"]})
                race = race_phase(export_dir, pool)
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
        served["din"] = serving_phase(
            export_dir, reqs, bad, "din",
            {"row_gather": rg, "segment_sum": ss},
            {"row_gather": 5, "segment_sum": 0})
        serve_cli_phase("train_din", export_dir, reqs[200])
    def median_p50(sv, b, mode):
        return float(np.median([x for x, _ in sv["predict_ms"][b][mode]]))

    print("served p50 latency (RAW1, one request at a time), REST / socket "
          "/ in-process graphed / in-process eager (median of the pairs' "
          "p50s): " + "; ".join(f"{name} " + ", ".join(
              f"batch {b}: {ms:.3f} / {sv['socket_p50_ms'][b]:.3f} / "
              f"{median_p50(sv, b, 'graphed'):.3f} / "
              f"{median_p50(sv, b, 'eager'):.3f} ms"
              for b, ms in sv["p50_ms"].items())
              for name, sv in served.items())
          + "; numpy engine p50: " + "; ".join(
              f"{name} " + ", ".join(f"batch {b}: {ms:.4f} ms"
                                     for b, ms in sv["numpy_p50_ms"].items())
              for name, sv in served.items() if "numpy_p50_ms" in sv)
          + f"; race: {race['captures']} captures while serving, largest "
          f"group {race['largest_group']} rows [{card}]", flush=True)
    print(json.dumps({"serving": {
        name: {k: sv[k] for k in ("p50_ms", "socket_p50_ms", "predict_ms",
                                  "profiles", "numpy_p50_ms") if k in sv}
        for name, sv in served.items()}, "race": race, "card": card},
        default=str), flush=True)

    def zoo(name, batch_size=16384, **kw):
        cfg = kw.pop("cfg", ModelConfig(name=name))
        return train_phase(name, ccfg, cfg, batch_size, dev, cin_kernel, ss,
                           rg, **kw)

    trained = {
        "DeepFM": zoo("deepfm"),
        "xDeepFM B=4096": zoo("xdeepfm", 4096, cfg=xcfg),
        "DCN": zoo("dcn"),
        "DeepFM fused": zoo("deepfm", cfg=ModelConfig(
            name="deepfm", emb_engine="fused"), reads=1),
        "FM": zoo("fm"),
        # DNN's table gradients are small enough that Adam's first steps,
        # which move a weight by about lr whatever its gradient's size, turn
        # float32 rounding into differences above 1e-4: its gradients are
        # compared instead of its parameters after 3 steps
        "DNN fused": zoo("dnn", cfg=ModelConfig(name="dnn",
                                                emb_engine="fused"), reads=1,
                         match="grads"),
        "wide (FTRL)": zoo("wide", reads=1, lr=WIDE_LR),
    }
    graphs = {
        "DeepFM": graph_vs_eager_phase("deepfm", ccfg, ModelConfig(), 16384,
                                       dev),
        "wide (FTRL)": graph_vs_eager_phase(
            "wide", ccfg, ModelConfig(name="wide"), 16384, dev, lr=WIDE_LR),
        "xDeepFM B=4096": graph_vs_eager_phase("xdeepfm", ccfg, xcfg, 4096,
                                               dev),
    }
    print(f"graphed vs eager, ex/s of each call [{card}]: "
          + "; ".join(f"{k}: eager {['%.0f' % x for x in v['eager']['ex_s']]}"
                      f", graphed {['%.0f' % x for x in v['graphed']['ex_s']]}"
                      for k, v in graphs.items()), flush=True)
    din = din_train_phase(din_train, din_eval, dev, rg, ss)
    stream = streaming_phase(ccfg, dev, rg, ss)
    din_fed = din_fed_phase(din_train, dev)
    print(f"training throughput [{card}]: "
          + ", ".join(f"{k} {v['ex_s']:.1f} ex/s" for k, v in trained.items())
          + f", DIN B={DIN_BATCHES[-1]} {din['ex_s']:.1f} ex/s, streaming "
          f"DeepFM {stream['ex_s']:.1f} ex/s (all B=16384 unless stated); "
          "host-fed graphed vs eager ex/s: streaming DeepFM "
          f"{['%.0f' % x for x in stream['fed']['graphed']['ex_s']]} vs "
          f"{['%.0f' % x for x in stream['fed']['eager']['ex_s']]} (the fast "
          f"path on the same rows {['%.0f' % x for x in stream['fast_ex_s']]}"
          f"), DIN {['%.0f' % x for x in din_fed['graphed']['ex_s']]} vs "
          f"{['%.0f' % x for x in din_fed['eager']['ex_s']]}", flush=True)
    train_cli_phase(ccfg)
    din_cli_phase()
    tsv_phase(ccfg)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    fused = trained["DeepFM fused"]["counts"]
    print(json.dumps({"kernels": [
        {"name": "cin_layer_fwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/cin_layer.cu",
         "replaces": "recsys_tpu/ops/pallas_cin.py:149",
         "note": "launches: xDeepFM training (serving_launches: xDeepFM "
                 "serving); ms: three layers at B=4096 back to back; "
                 "graph_ms: their device time in a CUDA graph; "
                 "graph_ms_by_n: per layer, at N = 16*B for B in "
                 f"{BATCHES}",
         "launches": trained["xDeepFM B=4096"]["counts"]["cin_fwd"],
         "serving_launches": served["xdeepfm"]["launches"]["cin_fwd"],
         **{k: fwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "graph_ms",
                                "layers", "graph_ms_by_n")}},
        {"name": "cin_layer_bwd", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/cin_backward.cu",
         "replaces": "recsys_tpu/ops/pallas_cin.py:180",
         "note": "launches: xDeepFM training; ms: three layers at B=4096 "
                 "back to back; graph_ms: their device time in a CUDA graph; "
                 "breakdown: per layer, each device operation's ms per call",
         "launches": trained["xDeepFM B=4096"]["counts"]["cin_bwd"],
         "breakdown": [{k: l[k] for k in ("fk", "h", "graph_ms",
                                          "breakdown")}
                       for l in bwd["layers"]],
         **{k: bwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "graph_ms")}},
        {"name": "segment_sum", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/segment_sum.cu",
         "replaces": "recsys_tpu/ops/pallas_kernels.py:334",
         "also_replaces": "recsys_tpu/ops/pallas_kernels.py:154",
         "note": "launches: fused-engine DeepFM training (one per step, "
                 "the :154 contract's FusedGatherEngine caller); ms, "
                 "plain_ms, library_ms (index_add_ into a zeroed buffer): "
                 "device time in a CUDA graph at the fused table at "
                 "B=16384 (638,976 ids into 840,704 x 17); "
                 "launches elsewhere: "
                 + ", ".join(f"{k} {v['counts']['segment_sum']}"
                             for k, v in trained.items())
                 + f", DIN {din['counts']['segment_sum']}, streaming DeepFM "
                 f"{stream['counts']['segment_sum']}",
         "launches": fused["segment_sum"],
         **{k: seg[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "shapes")}},
        {"name": "row_gather", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/row_gather.cu",
         "replaces": "scratch/rowdma_kernel.py:72",
         "note": "launches: DIN training (5 per step plus eval); "
                 "serving_launches: graphed serving, per model; "
                 f"fused-engine DeepFM training {fused['row_gather']} (one "
                 "per step); streaming DeepFM "
                 f"{stream['counts']['row_gather']} (2 per step plus eval); "
                 "ms: device time in a CUDA graph, DIN item table "
                 "at B=1024 plus Criteo big table at B=16384; the plain "
                 "version is the library call, index_select",
         "launches": din["counts"]["row_gather"],
         "serving_launches": {name: sv["launches"]["row_gather"]
                              for name, sv in served.items()},
         **{k: gat[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "shapes")}},
    ] + [
        {"name": name, "route": "cuda",
         "source": "recsys_tpu_torch/csrc/reshape_probe.cu",
         "replaces": f"scratch/mosaic_reshape_test.py:{line}",
         "note": "a compiler probe no path reaches: launches from the probe "
                 "phase's own run; ms: device time in a CUDA graph at "
                 f"VP={PROBE_ROWS}, W={PROBE_W}; library: torch.mul(x, 2.0)",
         **probe[key]}
        for name, key, line in (("reshape_probe_flat", "flat", 18),
                                ("reshape_probe_2d", "2d", 33))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
