#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``recsys_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA card and nvcc (CUDA_HOME or PATH)
    python3 chip_smoke.py --spmd-only   # the build and the SPMD phase alone,
                                        # its line and no result line

It fails (exit code other than 0, no result line) without a CUDA device or
without the package beside it. On a card it

1. prints the card's name and power limit (nvidia-smi) and builds the seven
   kernel sources, one nvcc each, all started together:
   ``csrc/cin_layer.cu`` (CIN forward), ``csrc/cin_backward.cu`` (CIN
   backward), ``csrc/segment_sum.cu`` (the embedding-gradient sum),
   ``csrc/row_gather.cu`` (the embedding forward gather),
   ``csrc/reshape_probe.cu`` (the two reshape probes),
   ``csrc/adam_update.cu`` (Adam's update over every leaf) and
   ``csrc/din_attention.cu`` (the work round DIN's attention products);
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
     the plain version there, at ragged lengths and at inputs 4, 8 and 12
     bytes off alignment; the kernel's grid, block and U beside what
     ``torch.profiler`` shows of it and of ``torch.mul(x, 2.0)``'s kernel;
     timed as a host loop and as device time in a CUDA graph beside
     ``torch.mul``, then in 5 interleaved rounds of plain, kernel,
     ``torch.mul``, ``torch.mul``, kernel, plain (median, min, max), hot
     and over 4 rotated input/output pairs;
   - Adam's update: 5 steps of ``optim.adam`` at full-width DeepFM's
     parameter tree (15 leaves, 14,382,482 parameters) and xDeepFM's (25
     leaves), at a constant rate and with a cosine schedule and weight
     decay, bitwise equal to the same steps through the plain loop, one
     launch a step covering every leaf; timed at each tree as device time
     in a CUDA graph and as a host loop, beside its bound (28 bytes a
     parameter) and with no library call (none computes TF-parity Adam);
     the training phases then count one launch a step over every leaf for
     every Adam model;
   - DIN's attention-unit kernels at the DIN cell's shapes (B = 1,024,
     P = 128, K = 32, hidden 80-40, dropout 0.1): the build, both
     epilogues and the pooling bitwise equal to their plain versions, the
     backward's head, epilogue backward, fold and column sums within 1e-6
     of each output's norm, each timed in a CUDA graph and back to back
     beside its bound; then one unit's forward (bitwise) and backward
     (within 1e-6) through the Function against autograd over the plain
     unit, timed in a CUDA graph; DIN's training phase then counts 8
     launches a unit a step and 4 an eval batch;
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
9. the multi-device path at one member: NCCL in a world of one rank, the
   dedup + all-to-all lookup of DeepFM's big table at batch 16384 (exact
   capacity) bitwise ``table_gather`` and the psum oracle, its table
   gradient (the owner gather's backward: the segment sum) within 1e-5
   of the local one, both timed; 5 full-width DeepFM steps (dropout 0)
   through the SPMD step with the exchange on, against the graphed local
   step from the same parameters (losses within 1e-4, parameters within
   one Adam step's tolerance, S1 and K2 launched twice a step), and the
   step times of each and of the local step run eagerly (``--spmd-only``
   runs this phase alone, after the build);
10. a 262,144-line Criteo-format TSV (about 20% of numeric and 10% of
   categorical fields missing): the native host library must have built,
   its parse must equal the pure-Python path on the first 5,000 rows, and
   ``preprocess_tsv`` shards it (rows/s printed); ``train_ctr train
   --streaming --device=cuda`` trains 100 steps on the shards and prints
   an eval line, and ``train_ctr eval`` runs on the checkpoint it left;
11. the CF family, which reaches no kernel of the port's own (dense
   matmuls, ``log_softmax``, ``topk``): an ML-20M-shaped set (136,677
   users, 20,108 items, about 10.0M interactions, 10,000 validation and
   10,000 test users) built as CSR from a seed; one epoch of
   ``vae_loop.train_vae_cf`` for ``multi_vae`` (234 steps of 500, then
   validation, checkpoint, ``best/`` and test); 30 steps timed one by one
   (host densify, the copy, the step's device time from CUDA events, the
   step with its loss read), users/s, 5 steps under ``torch.profiler``
   (busy time, idle share), eval ms a batch of 500;
   ``train_vae --device=cuda`` from the command line on the planted
   synthetic set at 20,108 items and 6,000 users (a dense host array of
   the generator is ~1 GB) for 5 epochs: its JSON line, ``best/`` and
   ``scalars.jsonl``, and the best validation NDCG@100 above a random
   ranking's of the same data; each VAE-CF model at full width, one
   batch's loss (1e-5 relative) and every gradient (1e-4 of the leaf's
   largest) on the card against the CPU, and one eval batch's NDCG@100 and
   Recall@20/50 from one set of logits (1e-6) and from each device's own
   (2e-3); CDAE at ML-100K's shape (943 x 1,682, hidden 50), 20 epochs:
   SuccessRate@1/5/10 against a random ranking's and ms an epoch; CAVI
   on 1M points from one initial state, the card stopping at the CPU's
   sweep with the means within 1e-4; and no kernel launch counted in the
   whole phase;
12. the convergence protocol's path: 1,048,576 rows drawn by the device
   sampler (``data/synthetic_device.py``) against as many rows of the host
   generator (label rate and dense mean within 0.01, each field's mean id
   within 3% of its vocab, every id in range); the sampler K-step call
   (``fast.make_scanned_train_step_sampler``) at full width, DeepFM on the
   split engine, batch 16384, dropout 0.5, Adam on a cosine schedule whose
   warm-up ends at step 20: graphed against eager from one seed, every
   parameter, BN stat and optimizer leaf and the mean loss bitwise equal
   after 40 steps, the graphed run launching the row gather and the
   segment sum twice a step (counted from 0 just before it), one
   ``cudaGraphLaunch`` a step (``torch.profiler``), its ex/s beside the
   devgen step's on the same model in alternating pairs; then
   ``tools/converge.py``'s DeepFM run on 5·10⁷ examples with eval on
   262,144 rows at start row 10⁹, its AUC above that slice's linear ceiling
   (computed on the host meanwhile) and printed beside the id-only one;
13. the classical models on the host: FTRL-proximal on a planted
   20,000-row Avazu-format CSV (held-out logloss below the base rate's);
   GBDT+LR (``tools/gbdt_fe``) where scikit-learn imports, else a line that
   says it was not run and why;
14. ``tools/results.py`` (FM, one epoch of 65,536 rows) and
   ``tools/bench_stream.py`` (131,072 rows) from the command line
   (``--device=cuda``), tiny, into a temporary directory.

Float32 matrix products run in full float32:
``torch.backends.cuda.matmul.allow_tf32 = False`` (and cuDNN's TF32 off).

The last two lines are one JSON object of the kernels' numbers and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
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
PROBE_ROUNDS = 5         # rounds of plain, kernel, library, library, ...
PROBE_PAIRS = 4          # rotated: 4 x 114 MB of buffers, over L2's 50 MB
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
DIN_UNIT = (1024, 128, 32, (80, 40))   # B, P, K, hidden: the DIN cell's units
DIN_UNIT_TIMED = 20            # calls a CUDA graph of the unit's kernels


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


def _capture(fn, iters: int):
    """``fn(0), fn(1), …, fn(iters - 1)`` captured in one CUDA graph, after
    a warm-up of ``fn(0..2)`` on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for j in range(3):
            fn(j)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for j in range(iters):
            fn(j)
    return graph


def _replay_ms(graph, iters: int) -> float:
    """Device time of one of the ``iters`` calls in ``graph``: one replay to
    warm up (what ran before leaves its traces in L2 for a while), then the
    mean of 5."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _graph_ms(fn, iters: int = 100) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so that the host's launch cost drops out."""
    return _replay_ms(_capture(lambda _: fn(), iters), iters)


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
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.utils.profiling import device_breakdown

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(r["op"][:70], r["total_ms"] / calls, r["count"] / calls)
            for r in device_breakdown(prof, top=None)]


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


def _kernel_launches(fn) -> list[dict]:
    """Name, grid and block of each kernel that ``fn()`` launches, read from
    a ``torch.profiler`` trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    return [{"name": e.get("name", ""), "grid": e.get("args", {}).get("grid"),
             "block": e.get("args", {}).get("block")}
            for e in events if e.get("cat") == "kernel"]


def reshape_probe_phase(rp, dev) -> dict:
    """The reshape probes at VP = 837,632, W = 17: each entry point once
    (the launches counted), then bitwise against the plain version there,
    at ragged lengths (n % 4 = 1, 2, 3; around one block's tile; below a
    warp) and at inputs 4, 8 and 12 bytes off 16-byte alignment; the float4
    path's grid, block and U, and the kernels that it and
    ``torch.mul(x, 2.0)`` launch (``torch.profiler``); timed in the order
    plain, kernel, kernel, plain as a host loop through the wrapper and as
    device time in a CUDA graph beside ``torch.mul``; then in
    `PROBE_ROUNDS` rounds of plain, kernel, library, library, kernel,
    plain, each a CUDA graph of 100 calls, hot (the same buffers every
    call) and rotated (`PROBE_PAIRS` input/output pairs in turn, more than
    L2 holds). → per entry point its numbers."""
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
    lib = rp._lib()
    launch = (ctypes.c_int * 3)()
    lib.vec_launch.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    lib.vec_launch.restype = None
    lib.vec_launch(flat.numel(), launch)
    grid, block, per = list(launch)
    tile = 4 * block * per                     # floats of one block's tile
    ragged = flat[1:1 + 1001 * PROBE_W]      # ragged and 4 bytes off
    cases = [
        ("flat", outs["flat"], want), ("2d", outs["2d"], want),
        ("flat ragged", rp.via_reshape(ragged, PROBE_W),
         rp.reshape_probe_reference(ragged, PROBE_W)),
        ("2d ragged", rp.via_2d(flat[:1001 * PROBE_W].view(1001, PROBE_W)),
         rp.reshape_probe_reference(flat[:1001 * PROBE_W], PROBE_W))]
    # W = 1, so that any length makes rows: n % 4 = 1, 2, 3 on an aligned
    # base; one tile, one float4 either side of it and a length that is not
    # a multiple of it; below a warp; 8 and 12 bytes off alignment
    for label, off, n in (
            [(f"n % 4 = {r}", 0, 3 * tile + r) for r in (1, 2, 3)]
            + [("one tile", 0, tile), ("one tile - 4", 0, tile - 4),
               ("one tile + 4", 0, tile + 4),
               ("5 tiles + 7", 0, 5 * tile + 7), ("below a warp", 0, 29),
               ("8 bytes off", 2, 1001 * PROBE_W),
               ("12 bytes off", 3, 1001 * PROBE_W)]):
        src = flat[off:off + n]
        ref = rp.reshape_probe_reference(src, 1)
        cases += [(f"flat {label}", rp.via_reshape(src, 1), ref),
                  (f"2d {label}", rp.via_2d(src.view(n, 1)), ref)]
    max_abs = 0.0
    for label, got, ref in cases:
        torch.cuda.synchronize()
        max_abs = max(max_abs, (got - ref).abs().max().item())
        _check(torch.equal(got, ref), f"reshape probe {label} differs from "
                                      "its plain version")
    print(f"reshape probes bitwise equal to the plain version in "
          f"{len(cases)} cases: " + ", ".join(c[0] for c in cases),
          flush=True)
    b_ms, b_by = _bound(2 * 4 * flat.numel(), flat.numel())
    out = torch.empty_like(x2)
    # the rotated pairs: PROBE_PAIRS inputs and outputs, used in turn
    srcs = [flat] + [torch.randn(flat.numel(), generator=gen).to(dev)
                     for _ in range(PROBE_PAIRS - 1)]
    dsts = [out] + [torch.empty_like(x2) for _ in range(PROBE_PAIRS - 1)]

    def entry(fn, src, dst):
        err = getattr(lib, fn)(src.data_ptr(), dst.data_ptr(), PROBE_ROWS,
                               PROBE_W,
                               torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"{fn} launch failed: {err}")

    traced = {what: _kernel_launches(f) for what, f in (
        ("kernel", lambda: entry("via_reshape", flat, out)),
        ("torch.mul", lambda: torch.mul(x2, 2.0, out=out)))}
    print(f"reshape probe launch: grid={grid} block={block} U={per} float4s "
          f"a thread ({tile} floats a block) for VP={PROBE_ROWS} W={PROBE_W}"
          "; traced: " + "; ".join(
              f"{what}: {k['name'][:120]} grid={k['grid']} block={k['block']}"
              for what, ks in traced.items() for k in ks), flush=True)
    res = {}
    for label, fn, shape, wrapper in (
            ("flat", "via_reshape", (-1,),
             lambda: rp.via_reshape(flat, PROBE_W)),
            ("2d", "via_2d", (PROBE_ROWS, PROBE_W), lambda: rp.via_2d(x2))):
        src = flat.view(shape)

        def kern(fn=fn, src=src):
            entry(fn, src, out)

        def plain(src=src):
            return rp.reshape_probe_reference(src, PROBE_W)

        def library(src=src):
            torch.mul(src, 2.0, out=out.view(src.shape))

        hk_ms, hp_ms = _timed_pair(wrapper, plain, 50)
        t = [_graph_ms(f) for f in (plain, kern, kern, plain)]
        k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        lib_ms = _graph_ms(library)
        # interleaved rounds, hot and rotated
        rounds = {}
        for mode, pairs in (("hot", 1), ("rotated", PROBE_PAIRS)):
            calls = {
                "plain": lambda j, s=shape, p=pairs:
                    rp.reshape_probe_reference(srcs[j % p].view(s), PROBE_W),
                "kernel": lambda j, f=fn, s=shape, p=pairs: entry(
                    f, srcs[j % p].view(s), dsts[j % p]),
                "library": lambda j, s=shape, p=pairs: torch.mul(
                    srcs[j % p].view(s), 2.0, out=dsts[j % p].view(s))}
            graphs = {what: _capture(c, 100) for what, c in calls.items()}
            times = {what: [] for what in graphs}
            for _ in range(PROBE_ROUNDS):
                for what in ("plain", "kernel", "library", "library",
                             "kernel", "plain"):
                    times[what].append(_replay_ms(graphs[what], 100))
            rounds[mode] = {what: [float(np.median(v)), min(v), max(v)]
                            for what, v in times.items()}
            del graphs
        hot = rounds["hot"]
        res[label] = {"launches": launches[label], "max_abs_err": max_abs,
                      "ms": hot["kernel"][0], "plain_ms": hot["plain"][0],
                      "library_ms": hot["library"][0],
                      "bound_ms": b_ms, "bound_by": b_by,
                      "host_ms": hk_ms, "host_plain_ms": hp_ms,
                      "median_min_max": rounds,
                      "graph_pkkp": {"ms": k_ms, "plain_ms": p_ms,
                                     "library_ms": lib_ms},
                      "launch": {"grid": grid, "block": block, "U": per}}
        print(f"reshape probe {fn} VP={PROBE_ROWS} W={PROBE_W}: bitwise; "
              f"device: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"torch.mul_ms={lib_ms:.4f} bound_ms={b_ms:.4f}; host loop: "
              f"wrapper_ms={hk_ms:.4f} plain_ms={hp_ms:.4f}", flush=True)
        for mode, r in rounds.items():
            print(f"reshape probe {fn} {mode} ({PROBE_ROUNDS} rounds of "
                  "plain, kernel, torch.mul, torch.mul, kernel, plain; "
                  "device ms a call, median [min, max]): " + ", ".join(
                      f"{what} {m:.5f} [{lo:.5f}, {hi:.5f}]"
                      for what, (m, lo, hi) in r.items())
                  + f"; kernel <= torch.mul: "
                  f"{r['kernel'][0] <= r['library'][0]}", flush=True)
    return res


ADAM_STEPS = 5                 # kernel against plain, from one state
ADAM_TIMED = 20                # updates in each timed CUDA graph


def _adam_tree(name, ccfg, dev, seed: int):
    """[params, grads, mu, nu], each a list of leaves on the card at
    full-width ``name``'s parameter shapes: weights and moments as after
    some steps (nu ≥ mu²), the gradients zero on 70% of each leaf's elements,
    as an embedding table's untouched rows are."""
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.models.api import make_model

    shapes = [t.shape for t in tree.leaves(make_model(
        name, ccfg, ModelConfig(name=name)).init(torch.Generator(),
                                                  "meta")[0])]
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, scale):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    mu = [draw(s, 1e-3) for s in shapes]
    return [[draw(s, 0.05) for s in shapes],
            [draw(s, 1e-2) * (torch.rand(s, generator=gen) < 0.3).to(dev)
             for s in shapes],
            mu, [m * m + draw(s, 1e-3) ** 2 for s, m in zip(shapes, mu)]]


def _adam_steps(tx, tree, steps: int, plain: bool):
    """``steps`` updates of ``tx`` on a copy of ``tree`` (the gradients
    scaled by the step), through the kernel or, with ``plain``, through
    the plain version in its place. → [params, mu, nu]."""
    from recsys_tpu_torch.ops import adam_update as au
    from recsys_tpu_torch.train import optim

    p, g, m, v = ([t.clone() for t in leaves] for leaves in tree)
    state = optim.AdamState(torch.zeros((), dtype=torch.int32,
                                        device=p[0].device), m, v)
    optim.adam_update = au.adam_update_reference if plain else \
        au.adam_update
    try:
        for s in range(steps):
            tx.update([gi * (1.0 + 0.25 * s) for gi in g], state, p)
    finally:
        optim.adam_update = au.adam_update
    torch.cuda.synchronize()
    return [p, m, v]


def adam_update_phase(au, ccfg, dev) -> dict:
    """Adam's kernel against its plain version on the card at full-width
    DeepFM's parameter tree (15 leaves, 14,382,482 parameters) and
    xDeepFM's (25 leaves): `ADAM_STEPS` steps of ``optim.adam`` from one
    state, at a constant rate and with a cosine schedule and weight decay,
    every leaf of the parameters and both moments bitwise equal, one
    launch a step covering every leaf. Timed at each tree as device time a
    call in a CUDA graph of `ADAM_TIMED` (plain, kernel, kernel, plain) and
    as a host loop through the wrapper, beside the bound: 28 bytes a
    parameter (p, g, m, v read, p, m, v written) over 3.35 TB/s. No PyTorch
    call computes TF-parity Adam (``torch._fused_adam_`` puts ε inside the
    bias correction), so there is no library time."""
    from recsys_tpu_torch.train import optim

    out = {}
    for name in ("deepfm", "xdeepfm"):
        tree = _adam_tree(name, ccfg, dev, seed=len(name))
        n_leaves, n = len(tree[0]), sum(t.numel() for t in tree[0])
        for label, tx in (
                ("constant rate", optim.adam(1e-3)),
                ("cosine schedule, weight decay", optim.adam(
                    optim.cosine_decay(1e-3, 8, warmup_steps=2),
                    weight_decay=0.01))):
            launches, leaves = au.LAUNCHES, au.LEAVES
            got = _adam_steps(tx, tree, ADAM_STEPS, plain=False)
            launches, leaves = au.LAUNCHES - launches, au.LEAVES - leaves
            want = _adam_steps(tx, tree, ADAM_STEPS, plain=True)
            differ = sum(int((a != b).sum()) for gs, ws in zip(got, want)
                         for a, b in zip(gs, ws))
            print(f"adam update {name} ({label}): {n_leaves} leaves, {n} "
                  f"parameters, {ADAM_STEPS} steps: {differ} elements of "
                  f"p, m, v differ from the plain version; {launches} "
                  f"launches covering {leaves} leaves", flush=True)
            _check(differ == 0, f"adam update {name} ({label}): {differ} "
                                "elements differ from the plain version")
            _check(launches == ADAM_STEPS and
                   leaves == ADAM_STEPS * n_leaves,
                   f"adam update {name}: {launches} launches covering "
                   f"{leaves} leaves in {ADAM_STEPS} steps, want one "
                   f"launch of {n_leaves} leaves a step")
        p, g, m, v = tree
        lr_t = torch.full((), 1e-3, device=dev)

        def kern():
            au.adam_update(p, g, m, v, lr_t, None, 0.9, 0.999, 1e-8)

        def plain():
            au.adam_update_reference(p, g, m, v, lr_t, None, 0.9, 0.999,
                                     1e-8)

        t = [_graph_ms(f, ADAM_TIMED) for f in (plain, kern, kern, plain)]
        k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        hk_ms, hp_ms = _timed_pair(kern, plain, ADAM_TIMED)
        b_ms, _ = _bound(28 * n, 0)
        out[name] = {"leaves": n_leaves, "parameters": n, "ms": k_ms,
                     "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                     "bound_by": "bytes", "host_ms": hk_ms,
                     "host_plain_ms": hp_ms}
        print(f"adam update {name}: device ms a call in a CUDA graph: "
              f"kernel {k_ms:.4f} (plain, kernel, kernel, plain: "
              f"{', '.join('%.4f' % x for x in t)}), plain {p_ms:.4f}, "
              f"bound {b_ms:.4f} (bytes: {b_ms / k_ms:.1%} of it); host "
              f"loop: wrapper {hk_ms:.4f}, plain {hp_ms:.4f}", flush=True)
    return out


def din_attention_phase(da, dev) -> dict:
    """DIN's attention-unit kernels (``csrc/din_attention.cu``) against
    their plain versions on the card at the DIN cell's shapes (`DIN_UNIT`:
    B = 1,024, P = 128, K = 32, hidden 80-40, dropout 0.1, about 31.5% of
    the positions padding): the forward's kernels bitwise equal to theirs
    (the epilogue at both layers, the pooling with its ``torch.sum``), the
    backward's within 1e-6 of each output's norm; each timed as device time
    a call in a CUDA graph of `DIN_UNIT_TIMED` (plain, kernel, kernel,
    plain) and back to back, beside its bound (its bytes, each read and
    write once, over 3.35 TB/s); then one unit's forward and backward
    through the Function against autograd over the plain unit. No single
    PyTorch call computes any of them, so there is no library time."""
    from recsys_tpu_torch.ops import interactions

    b, p, k, widths = DIN_UNIT
    rows = b * p
    gen = torch.Generator().manual_seed(22)
    params = interactions.din_attention_init(gen, k, widths, "cpu")
    for layer in (*params["mlp"], params["out"]):
        layer["b"] = 0.05 * torch.randn(layer["b"].shape, generator=gen)
    params = {"mlp": [{n: t.to(dev) for n, t in l.items()}
                      for l in params["mlp"]],
              "out": {n: t.to(dev) for n, t in params["out"].items()}}
    hist = torch.randn(b, p, k, generator=gen).to(dev)
    query = torch.randn(b, k, generator=gen).to(dev)
    ids = (torch.randint(1, 27_279, (b, p), generator=gen)
           * (torch.rand(b, p, generator=gen) >= 0.315)).to(dev)
    dout = torch.randn(b, k, generator=gen).to(dev)
    keep = 0.9
    draw = torch.Generator(device=dev).manual_seed(5)
    rands = [torch.rand((rows, h), generator=draw, device=dev)
             for h in widths]
    (w1, b1), (w2, b2) = [(l["w"], l["b"]) for l in params["mlp"]]
    w_out, b_out = params["out"]["w"], params["out"]["b"]
    x = da.build_reference(hist, query)
    z1 = x @ w1
    a1 = da.epilogue_reference(z1, b1, rands[0], keep)
    z2 = a1 @ w2
    a2 = da.epilogue_reference(z2, b2, rands[1], keep)
    m = a2 @ w_out
    _, wgt = da.pool_reference(hist, ids, m, b_out)
    dz2, _, _, _ = da.head_backward_reference(dout, hist, ids, a2, w_out,
                                              keep, True)
    da1 = dz2 @ w2.t()
    dz1, _ = da.epilogue_backward_reference(da1, a1, keep)
    dx = dz1 @ w1.t()
    parts = da.partials(rows, [widths[0], widths[1], widths[1], 1], dev)
    # the in-place kernels' buffers: their first call is checked, later
    # calls only timed
    z1b, z2b, da1b = z1.clone(), z2.clone(), da1.clone()
    f4, i8 = 4, 8                       # bytes of a float32 and of an id
    cases = [
        ("din_build", lambda: da.build(hist, query),
         lambda: da.build_reference(hist, query),
         f4 * (rows * k + b * k + rows * 4 * k), "bitwise"),
        ("din_epilogue (80)", lambda: da.epilogue(z1b, b1, rands[0], keep),
         lambda: da.epilogue_reference(z1, b1, rands[0], keep),
         f4 * 3 * rows * widths[0], "bitwise"),
        ("din_epilogue (40)", lambda: da.epilogue(z2b, b2, rands[1], keep),
         lambda: da.epilogue_reference(z2, b2, rands[1], keep),
         f4 * 3 * rows * widths[1], "bitwise"),
        ("din_pool + sum", lambda: da.pool(hist, ids, m, b_out),
         lambda: da.pool_reference(hist, ids, m, b_out),
         f4 * (3 * rows * k + 2 * rows + b * k) + i8 * rows, "bitwise"),
        ("din_head_backward", lambda: da.head_backward_kernel(
            dout, hist, ids, a2, w_out, keep, True, *parts[1:]),
         lambda: da.head_backward_reference(dout, hist, ids, a2, w_out,
                                            keep, True)[0],
         f4 * (rows * k + 2 * rows * widths[1]) + i8 * rows, "1e-6"),
        ("din_epilogue_backward", lambda: da.epilogue_backward_kernel(
            da1b, a1, keep, parts[0]),
         lambda: da.epilogue_backward_reference(da1, a1, keep)[0],
         f4 * 3 * rows * widths[0], "1e-6"),
        ("din_fold", lambda: da.fold_kernel(dx, dout, hist, query, ids, wgt),
         lambda: da.fold_reference(dx, dout, hist, query, ids, wgt),
         f4 * (rows * 4 * k + 2 * rows * k + rows) + i8 * rows, "1e-6"),
        ("din_column_sums", lambda: da.column_sums_kernel(parts, dev),
         lambda: [t.sum(dim=0) for t in parts],
         8 * sum(t.numel() for t in parts), "1e-6"),
    ]
    out = {}
    for name, kern, plain, nbytes, want in cases:
        launches = da.LAUNCHES
        got = kern()
        launches = da.LAUNCHES - launches
        ref = plain()
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        if want == "bitwise":
            ok = all(torch.equal(g, r) for g, r in zip(got, ref, strict=True))
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        else:
            err = max(float((g.double() - r.double()).norm())
                      / max(float(r.double().norm()), 1e-30)
                      for g, r in zip(got, ref, strict=True))
            ok = err <= 1e-6
        _check(ok and launches == 1,
               f"{name}: {launches} launches, differs from the plain version "
               f"by {err} (want {want})")
        t = [_graph_ms(f, DIN_UNIT_TIMED) for f in (plain, kern, kern, plain)]
        k_ms, p_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        host_ms, _ = _timed_pair(kern, plain, DIN_UNIT_TIMED)
        b_ms, by = _bound(nbytes, 0)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "host_ms": host_ms,
                     "bound_ms": b_ms, "bound_by": by, "max_err": err,
                     "launches_a_call": launches, "library_ms": None}
        print(f"din attention {name}: device ms a call in a CUDA graph: "
              f"kernel {k_ms:.4f} (plain, kernel, kernel, plain: "
              f"{', '.join('%.4f' % v for v in t)}), plain {p_ms:.4f}, "
              f"back to back {host_ms:.4f}, bound {b_ms:.4f} ({by}: "
              f"{b_ms / k_ms:.1%} of it); {want} against the plain version "
              f"(max error {err:.3e})", flush=True)

    def unit(run, g):
        leaves = [t.detach().requires_grad_() for t in
                  (hist, query, w1, b1, w2, b2, w_out, b_out)]
        h, q, *w = leaves
        live = {"mlp": [{"w": w[0], "b": w[1]}, {"w": w[2], "b": w[3]}],
                "out": {"w": w[4], "b": w[5]}}
        y = run(live, h, q, g)
        return (y, *torch.autograd.grad(y, leaves, dout))

    def kern_run(w, h, q, g):
        return da.din_attention_unit(w, h, ids, q, train=True,
                                     dropout_rate=0.1, gen=g)

    def plain_run(w, h, q, g):
        return interactions.din_attention_plain(w, h, ids, q, train=True,
                                                dropout_rate=0.1, gen=g)

    got, ref = [unit(run, torch.Generator(device=dev).manual_seed(5))
                for run in (kern_run, plain_run)]
    # a capture draws from the card's default generator, which it registers
    default = torch.cuda.default_generators[torch.cuda.current_device()]

    def kern_unit():
        return unit(kern_run, default)

    def plain_unit():
        return unit(plain_run, default)

    _check(torch.equal(got[0], ref[0]), "din attention unit: the forward "
           "differs from the plain unit's")
    err = max(float((g.double() - r.double()).norm())
              / max(float(r.double().norm()), 1e-30)
              for g, r in zip(got[1:], ref[1:]))
    _check(err <= 1e-6, f"din attention unit: gradients differ by {err}")
    t = [_graph_ms(f, 5) for f in (plain_unit, kern_unit, kern_unit,
                                   plain_unit)]
    out["unit"] = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                   "max_grad_err": err}
    print(f"din attention unit, forward and backward (B={b}, P={p}, K={k}, "
          f"80-40): device ms a call in a CUDA graph: Function "
          f"{out['unit']['ms']:.4f}, plain unit with autograd "
          f"{out['unit']['plain_ms']:.4f} (plain, Function, Function, "
          f"plain: {', '.join('%.4f' % v for v in t)}); forward bitwise, "
          f"gradients within {err:.2e} of each one's norm", flush=True)
    return out


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
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.ops import adam_update as au
    from recsys_tpu_torch.train import fast, optim
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
    cin_kernel.BWD_LAUNCHES = au.LAUNCHES = au.LEAVES = 0
    losses, t_calls = [], []
    for c in range(TRAIN_STEPS // K):        # the training path starts here
        t0 = time.perf_counter()
        ts, loss = step_fn(ts, staged, K, c * K)
        losses.append(float(loss))           # one host read per call
        t_calls.append(time.perf_counter() - t0)
    counts = {"segment_sum": ss.LAUNCHES, "row_gather": rg.LAUNCHES,
              "cin_fwd": cin_kernel.LAUNCHES,
              "cin_bwd": cin_kernel.BWD_LAUNCHES, "adam": au.LAUNCHES,
              "adam_leaves": au.LEAVES}            # ... and ends here
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
    # one Adam launch a step covers every leaf (wide trains with FTRL)
    n_adam = (len(tree.leaves(ts.params))
              if isinstance(ts.opt_state, optim.AdamState) else 0)
    _check(counts["adam"] == steps * (n_adam > 0) and
           counts["adam_leaves"] == steps * n_adam,
           f"{label}: Adam launches {counts['adam']} covering "
           f"{counts['adam_leaves']} leaves for {steps} steps, want one "
           f"launch of {n_adam} leaves a step")
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
    from recsys_tpu_torch.ops import din_attention
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
        counters = {"segment_sum": ss, "row_gather": rg,
                    "din_attention": din_attention}
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
    # 8 kernels a unit a training step, 4 an eval batch (two units each)
    want = 16 * DIN_STEPS + 8 * n_eval
    _check(counts["din_attention"] == want,
           f"DIN: {counts['din_attention']} attention-unit launches for "
           f"{DIN_STEPS} steps and {n_eval} eval batches, want {want}")
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
    the card (``bench_stream.pipeline_rates``, its s2 and s3)."""
    from recsys_tpu_torch.tools.bench_stream import pipeline_rates

    rates = pipeline_rates(src, dev, FED_STEPS)
    print(f"input pipeline alone, {FED_STEPS} batches: ShardSource "
          f"{rates['shard_source']:.0f} rows/s on the host, through "
          f"device_prefetch {rates['device_prefetch']:.0f} rows/s to the "
          "card", flush=True)
    return {k: rates[k] for k in ("shard_source", "device_prefetch")}


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


def _owner_gather_kernels(a2a, fwd_bwd, rg, ss) -> dict:
    """S1 and K2 at the shapes the sharded lookup's owner gather gives
    them: their inputs recorded during one forward + backward of ``a2a``,
    then each wrapper against its plain version (S1 bitwise; K2 within
    1e-5 of each row's Σ|g|) and timed as device time in a CUDA graph
    (order plain, kernel, kernel, plain) beside the library call
    (``index_select``; ``index_add_`` into a buffer zeroed once) and its
    bound. → {'s1': …, 'k2': …}"""
    seen = {}
    real = rg.row_gather, ss.segment_sum

    def rec_gather(table, ids):
        seen["s1"] = (table.detach(), ids)
        return real[0](table, ids)

    def rec_sum(ids, grads, rows):
        seen["k2"] = (ids, grads.detach(), rows)
        return real[1](ids, grads, rows)

    rg.row_gather, ss.segment_sum = rec_gather, rec_sum
    try:
        fwd_bwd(a2a)
    finally:
        rg.row_gather, ss.segment_sum = real
    out = {}
    table, ids = seen["s1"]
    n, w = ids.shape[0], table.shape[1]
    got = rg.row_gather(table, ids)
    _check(torch.equal(got, torch.index_select(table, 0, ids)),
           "SPMD: the owner gather's row gather differs from index_select")
    sel = torch.empty_like(got)
    t = [_graph_ms(f) for f in (
        lambda: torch.index_select(table, 0, ids, out=sel),
        lambda: rg.row_gather(table, ids),
        lambda: rg.row_gather(table, ids),
        lambda: torch.index_select(table, 0, ids, out=sel))]
    b_ms, b_by = _bound(8 * n + 4 * w * (int(torch.unique(ids).numel()) + n),
                        0)
    out["s1"] = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                 "library_ms": (t[0] + t[3]) / 2, "bound_ms": b_ms,
                 "bound_by": b_by, "max_abs_err": 0.0,
                 "shape": [n, list(table.shape)]}
    ids, grads, rows = seen["k2"]
    n, w = grads.shape
    got = ss.segment_sum(ids, grads, rows)
    ref = ss.segment_sum_reference(ids, grads, rows)
    scale = ss.segment_sum_reference(ids, grads.abs(), rows)
    err = (got - ref).abs()
    _check(bool((err <= 1e-5 * scale + 1e-6).all()),
           "SPMD: the owner gather's segment sum disagrees with its plain "
           "version")
    buf = torch.zeros_like(got)
    t = [_graph_ms(f) for f in (
        lambda: ss.segment_sum_reference(ids, grads, rows),
        lambda: ss.segment_sum(ids, grads, rows),
        lambda: ss.segment_sum(ids, grads, rows),
        lambda: ss.segment_sum_reference(ids, grads, rows))]
    b_ms, b_by = _bound(_segment_sum_bytes(n, w, rows), n * w)
    out["k2"] = {"ms": (t[1] + t[2]) / 2, "plain_ms": (t[0] + t[3]) / 2,
                 "library_ms": _graph_ms(lambda: buf.index_add_(0, ids,
                                                                grads)),
                 "bound_ms": b_ms, "bound_by": b_by,
                 "max_abs_err": float(err.max()),
                 "shape": [n, rows, w],
                 "unique_ids": int(torch.unique(ids).numel())}
    return out


SPMD_STEPS = 5                 # SPMD against local, from one state
SPMD_TIMED = 10                # steps in each timed run


def spmd_phase(ccfg, dev, rg, ss) -> dict:
    """The multi-device path at one member over NCCL: the process group of
    a world of one rank (a file store in a temporary directory) on the
    card, then

    - the dedup + all-to-all lookup (``exact``) of full-width DeepFM's big
      table at batch 16384: forward bitwise ``table_gather``'s and the psum
      oracle's, the table gradient (the owner gather's backward: the
      segment sum, K2's contract) within 1e-5 of the local gather's, its
      forward plus backward timed back to back and as device time under
      ``torch.profiler`` beside the local gather's;
    - full-width DeepFM (dropout 0, Adam 1e-3, batch 16384) trained
      SPMD_STEPS steps through ``make_spmd_train_step`` with sharded ops
      built for the one-member model axis (so the exchange runs) and through
      the graphed host-fed local step, from the same parameters: every loss
      within 1e-4, the parameters within one Adam step's tolerance
      (tests/test_spmd.py), the launches of S1 and K2 counted over the SPMD
      steps alone; then SPMD_TIMED-step runs of each, and of the local
      step run eagerly, in the order SPMD, graphed, eager, eager, graphed,
      SPMD. The threads alive at the phase's start are reported.

    The process group is destroyed at the end. → numbers of the run."""
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.core.config import MeshConfig, ModelConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.embeddings import table as emb_table
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.parallel import sharded_embedding as SE
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    batch_size = 16384
    model = make_model("deepfm", ccfg, ModelConfig(dropout=0.0))
    batches = [fast.stage_dataset(synthetic_criteo(
        batch_size, ccfg, start_row=i * batch_size), dev)
        for i in range(SPMD_STEPS + 1)]
    out = {"threads": sorted(t.name for t in threading.enumerate())}
    with tempfile.TemporaryDirectory() as tmp:
        device = mesh_lib.distributed_init(f"file://{tmp}/store", 1, 0,
                                           timeout_s=300)
        try:
            _check(dist.get_backend() == "nccl" and device.type == "cuda",
                   f"SPMD: process group {dist.get_backend()} on {device}")
            env = mesh_lib.make_mesh(MeshConfig(), device)

            # the exchange on the big table
            params, _ = model.init(torch.Generator().manual_seed(0), device)
            table = params["tables"]["big"]
            (_, _, fields, offsets), = [
                c for c in model.meta["engine"]._index_tensors(device)
                if c[0] == "big"]
            gids = batches[0]["ids"].index_select(1, fields) + offsets
            got = SE.a2a_embedding_lookup(table, gids, env.model, exact=True)
            _check(torch.equal(got, emb_table.table_gather(table, gids)) and
                   torch.equal(got, SE.psum_embedding_lookup(table, gids,
                                                             env.model)),
                   "SPMD: the a2a lookup is not bitwise the table gather "
                   "and the psum lookup")
            g_out = torch.randn(*got.shape, device=device,
                                generator=torch.Generator(device)
                                .manual_seed(3))
            live = table.detach().clone().requires_grad_()

            def fwd_bwd(lookup):
                return torch.autograd.grad((lookup(live) * g_out).sum(),
                                           live)[0]

            def a2a(t):
                return SE.a2a_embedding_lookup(t, gids, env.model,
                                               exact=True)

            def local(t):
                return emb_table.table_gather(t, gids)

            g_a2a, g_local = fwd_bwd(a2a), fwd_bwd(local)
            rel = float((g_a2a - g_local).abs().max()
                        / g_local.abs().max())
            _check(rel <= 1e-5, f"SPMD: the a2a table gradient is {rel} "
                   "of the largest off the local one (tolerance 1e-5)")
            out.update(_owner_gather_kernels(a2a, fwd_bwd, rg, ss))
            for name, lookup in (("a2a", a2a), ("local", local)):
                def fn():
                    fwd_bwd(lookup)
                ops = _device_breakdown(fn)
                out[name] = {"ms": _cuda_ms(fn, 20),
                             "device_ms": sum(r[1] for r in ops),
                             "top_ops": [r[:2] for r in ops[:6]]}
            out["lookup"] = {"ids": int(gids.numel()),
                             "table": list(table.shape),
                             "grad_rel_err": rel}

            # SPMD steps against the graphed local step
            ts_l, tx = TS.create_train_state(model, 0, 1e-3, device)
            ts_s = spmd.create_spmd_state(model, env, 0, tx)
            local_step = fast.make_fed_train_step(model, tx)
            eager_step = fast.make_fed_train_step(model, tx, graphed=False)
            spmd_step = spmd.make_spmd_train_step(
                model, tx, env, len(batches[0]["label"]),
                emb_ops=spmd.sharded_emb_ops(env.model, exact=True))
            losses = {"spmd": [], "local": []}
            torch.cuda.synchronize()
            ss.LAUNCHES = rg.LAUNCHES = 0       # the SPMD path starts here
            for i in range(SPMD_STEPS):
                ts_s, loss = spmd_step(ts_s, batches[i], i)
                losses["spmd"].append(float(loss))
            counts = {"segment_sum": ss.LAUNCHES,
                      "row_gather": rg.LAUNCHES}   # ... and ends here
            for i in range(SPMD_STEPS):
                losses["local"].append(float(local_step(ts_l, batches[i],
                                                        i)))
            loss_diff = max(abs(a - b) for a, b in zip(losses["spmd"],
                                                       losses["local"]))
            worst = (0.0, 0.0)
            for a, b in zip(tree.leaves(ts_s.params),
                            tree.leaves(ts_l.params)):
                d = (a - b).abs()
                worst = (max(worst[0], float(d.max())),
                         max(worst[1], float(d.mean())))
            _check(loss_diff <= 1e-4, f"SPMD: losses {losses} differ by "
                   f"{loss_diff} (tolerance 1e-4)")
            _check(worst[0] <= 5e-3 and worst[1] < 2e-4,
                   f"SPMD: parameters after {SPMD_STEPS} steps differ by "
                   f"{worst[0]} at most, {worst[1]} on average (tolerance "
                   "5e-3 and 2e-4)")
            _check(counts["segment_sum"] == 2 * SPMD_STEPS and
                   counts["row_gather"] == 2 * SPMD_STEPS,
                   f"SPMD: launches {counts} over {SPMD_STEPS} steps, want "
                   f"{2 * SPMD_STEPS} each (the small table's read and the "
                   "big table's owner gather)")
            step_ms = {"spmd": [], "local": [], "eager": []}
            done = SPMD_STEPS
            for mode in ("spmd", "local", "eager", "eager", "local", "spmd"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(SPMD_TIMED):
                    batch = batches[i % len(batches)]
                    if mode == "spmd":
                        ts_s, loss = spmd_step(ts_s, batch, done + i)
                    elif mode == "local":
                        loss = local_step(ts_l, batch, done + i)
                    else:
                        loss = eager_step(ts_l, batch, done + i)
                torch.cuda.synchronize()
                step_ms[mode].append((time.perf_counter() - t0) * 1e3
                                     / SPMD_TIMED)
                done += SPMD_TIMED
        finally:
            dist.destroy_process_group()
    out.update(counts=counts, losses=losses, loss_diff=loss_diff,
               param_diff=worst, step_ms=step_ms)
    return out


def _report_spmd(sp: dict, card: str) -> None:
    print(f"SPMD at one member over NCCL [{card}]: DeepFM's big table, "
          f"{sp['lookup']['ids']} ids into {sp['lookup']['table']}: the a2a "
          f"lookup's forward + backward {sp['a2a']['ms']:.4f} ms back to "
          f"back, {sp['a2a']['device_ms']:.4f} ms of device time (the local "
          f"gather's {sp['local']['ms']:.4f} / "
          f"{sp['local']['device_ms']:.4f} ms), gradient within "
          f"{sp['lookup']['grad_rel_err']:.2e} of the local one; "
          f"{SPMD_STEPS} DeepFM steps at batch 16384: eager SPMD step "
          f"{['%.3f' % x for x in sp['step_ms']['spmd']]} ms against the "
          f"graphed local step {['%.3f' % x for x in sp['step_ms']['local']]}"
          f" ms and the eager local step "
          f"{['%.3f' % x for x in sp['step_ms']['eager']]} ms (order SPMD, "
          "graphed, eager, eager, graphed, SPMD), losses within "
          f"{sp['loss_diff']:.2e}, parameters within {sp['param_diff'][0]:.2e}"
          f" (mean {sp['param_diff'][1]:.2e}); launches on the SPMD steps "
          f"{sp['counts']}; device ops of the a2a forward + backward "
          f"{sp['a2a']['top_ops']}; the owner gather's kernels, device ms "
          f"in a CUDA graph: row gather {sp['s1']['ms']:.4f} (index_select "
          f"{sp['s1']['plain_ms']:.4f}, bound {sp['s1']['bound_ms']:.4f}), "
          f"segment sum {sp['k2']['ms']:.4f} (plain "
          f"{sp['k2']['plain_ms']:.4f}, index_add_ "
          f"{sp['k2']['library_ms']:.4f}, bound {sp['k2']['bound_ms']:.4f};"
          f" {sp['k2']['unique_ids']} distinct of {sp['k2']['shape'][0]} "
          f"ids); threads alive at the phase's start: {sp['threads']}",
          flush=True)


# ---------------------------------------------------------------------------
# the CF family: no kernel of the port's own lies on its path
# ---------------------------------------------------------------------------

CF_USERS, CF_ITEMS = 136_677, 20_108   # ML-20M after the VAE-CF protocol
CF_INTERACTIONS = 10_000_000
CF_DRAWS = 1.076                       # draws per kept interaction (dedup)
CF_HELDOUT = 10_000                    # validation users, and test users
CF_BATCH = 500
CF_TIMED_STEPS = 30
CF_PROFILED_STEPS = 5
CF_LEARN_USERS = 6_000     # a dense [U, 20,108] float64 host array: 0.97 GB
CF_LEARN_HELDOUT = 500
CF_LEARN_EPOCHS = 5
CF_LOSS_RTOL = 1e-5        # float32 sums over 20,108 items in cuBLAS's order
CF_GRAD_TOL = 1e-4         # of each gradient leaf's largest magnitude
CF_METRIC_TOL = 1e-6       # the metrics of one set of logits on each device
CF_SCORE_TOL = 2e-3        # the metrics of each device's own logits
CDAE_USERS, CDAE_ITEMS, CDAE_HIDDEN = 943, 1_682, 50     # ML-100K
CDAE_EPOCHS = 20
CAVI_MEANS = (-4.0, 0.0, 4.0, 9.0)
CAVI_PER_CLUSTER = 250_000
# the ELBO of 1M points is ~1.4e7, resolved to ~1.0 in float32; its
# differences (float64) run 1078, 171, 30.4, 5.6: epsilon sits in a gap
CAVI_EPS = 70.0
CAVI_TOL = 1e-4            # means: float32 sums of 1M terms in another order


def ml20m_shaped(seed: int):
    """A `VaeCfData` of ML-20M's shape after the VAE-CF protocol: 136,677
    users (116,677 training, 10,000 validation and 10,000 test users, each
    held-out user's items split 80/20 into fold-in and held-out), 20,108
    items and about 10.0M interactions, built from numpy as CSR directly
    (`synthetic_interactions` would build dense [U, I] float64 arrays of
    22 GB): log-normal per-user counts of at least 5, items drawn from a
    Zipf-like popularity, repeats dropped."""
    from scipy import sparse

    from recsys_tpu_torch.data.movielens import VaeCfData

    rng = np.random.default_rng(seed)
    raw = np.exp(rng.normal(0.0, 1.0, CF_USERS))
    counts = np.clip(np.round(raw * CF_INTERACTIONS * CF_DRAWS / raw.sum()),
                     5, CF_ITEMS).astype(np.int64)
    pop = 1.0 / (np.arange(CF_ITEMS) + 10.0) ** 0.9
    pop = rng.permutation(pop / pop.sum())
    rows = np.repeat(np.arange(CF_USERS, dtype=np.int64), counts)
    keys = np.unique(rows * CF_ITEMS + rng.choice(CF_ITEMS, rows.size, p=pop))
    rows, cols = keys // CF_ITEMS, (keys % CF_ITEMS).astype(np.int32)

    def csr(mask, lo, n):
        r = rows[mask] - lo
        indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
        return sparse.csr_matrix((np.ones(len(r), np.float32), cols[mask],
                                  indptr), shape=(n, CF_ITEMS))

    def split(lo, hi):
        sel = (rows >= lo) & (rows < hi)
        r = rows[sel]
        n_u = np.bincount(r - lo, minlength=hi - lo)
        start = np.concatenate([[0], np.cumsum(n_u)])[:-1]
        n_held = np.where(n_u >= 5, np.maximum(1, (0.2 * n_u).astype(int)), 0)
        order = np.lexsort((rng.random(len(r)), r))
        rank = np.arange(len(r)) - start[r[order] - lo]
        held = np.empty(len(r), bool)
        held[order] = rank < n_held[r[order] - lo]
        tr, te = sel.copy(), sel.copy()
        tr[sel], te[sel] = ~held, held
        return csr(tr, lo, hi - lo), csr(te, lo, hi - lo)

    n_train = CF_USERS - 2 * CF_HELDOUT
    return VaeCfData(csr(rows < n_train, 0, n_train),
                     *split(n_train, n_train + CF_HELDOUT),
                     *split(n_train + CF_HELDOUT, CF_USERS), CF_ITEMS)


def _cf_steps(data, cfg, dev) -> dict:
    """`vae_loop`'s train step on ``data``'s first batches, one step at a
    time: host densify, the host-to-device copy, the step's device time
    (CUDA events from its first launch to its last kernel) and the step's
    wall time with its loss read, as the trainer reads it; then
    ``CF_PROFILED_STEPS`` steps under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    from recsys_tpu_torch.models import vae_cf as V
    from recsys_tpu_torch.tools.profile_step import trace_numbers
    from recsys_tpu_torch.train import optim, vae_loop
    from recsys_tpu_torch.train.train_state import make_generator, step_seed
    from recsys_tpu_torch.utils.profiling import device_time_us

    (init, apply, loss_fn), vae = vae_loop.make_model(cfg, data.n_items)
    params = init(torch.Generator().manual_seed(cfg.seed), dev)
    opt = optim.adam(cfg.learning_rate)
    opt_state = opt.init(params)
    step = vae_loop.make_train_step(loss_fn, vae, opt, cfg.keep_prob)
    gen = make_generator(cfg.seed + 1, dev)
    order = np.random.default_rng(cfg.seed).permutation(data.train.shape[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def one(i: int) -> tuple:
        t0 = time.perf_counter()
        xh = vae_loop.dense_rows(data.train,
                                 order[i * CF_BATCH:(i + 1) * CF_BATCH])
        t1 = time.perf_counter()
        x = torch.from_numpy(xh).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gen.manual_seed(step_seed(cfg.seed + 1, i))
        start.record()
        loss = step(params, opt_state, x, gen,
                    V.anneal_schedule(i, cfg.anneal_cap,
                                      cfg.total_anneal_steps))
        end.record()
        _check(np.isfinite(float(loss)), f"CF step {i}: loss {float(loss)}")
        t3 = time.perf_counter()
        end.synchronize()
        return ((t3 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                start.elapsed_time(end))

    for i in range(3):
        one(i)
    rec = np.array([one(i) for i in range(3, 3 + CF_TIMED_STEPS)])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(CF_PROFILED_STEPS):
            one(100 + i)
        torch.cuda.synchronize()
    trace = trace_numbers(prof, CF_PROFILED_STEPS)
    stats = {k: [float(np.median(c)), float(c.min()), float(c.max())]
             for k, c in zip(("step_ms", "densify_ms", "copy_ms",
                              "device_ms"), rec.T)}
    stats["users_per_s"] = CF_BATCH / stats["step_ms"][0] * 1e3
    stats["busy_ms"] = trace["device_busy_ms_per_step"]
    stats["copy_busy_ms"] = sum(
        device_time_us(e) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.key.startswith("Memcpy")
    ) / 1e3 / CF_PROFILED_STEPS
    stats["device_ops"] = trace["device_ops_per_step"]
    stats["idle_share"] = 1.0 - stats["busy_ms"] / stats["step_ms"][0]
    stats["compute_idle_share"] = 1.0 - ((stats["busy_ms"]
                                          - stats["copy_busy_ms"])
                                         / stats["step_ms"][0])
    stats["top"] = trace["top"][:3]
    evaluate = vae_loop.make_eval_fn(apply, vae, CF_BATCH, dev)
    for _ in range(2):                         # the second call is timed
        t0 = time.perf_counter()
        evaluate(params, data.vad_tr, data.vad_te)
        stats["eval_ms_per_batch"] = ((time.perf_counter() - t0) * 1e3
                                      / (CF_HELDOUT / CF_BATCH))
    return stats


def _cf_card_vs_cpu(data, dev) -> dict:
    """Each VAE-CF model at full width: one batch's loss and gradients at
    ``train=False`` on the card against the CPU; NDCG@100 and Recall@20/50
    of one eval batch (multi_vae), from one set of logits on both devices
    and from each device's own."""
    from recsys_tpu_torch.core import tree as tree_util
    from recsys_tpu_torch.train import vae_loop

    x = torch.from_numpy(vae_loop.dense_rows(data.train, np.arange(CF_BATCH)))
    out = {}
    for model in ("multi_dae", "logistic_vae", "multi_vae"):  # vae last
        cfg = vae_loop.VaeTrainConfig(model=model, lam=0.01)
        (init, apply, loss_fn), vae = vae_loop.make_model(cfg, data.n_items)
        params = init(torch.Generator().manual_seed(3), "cpu")
        card = tree_util.tree_map(lambda t: t.to(dev), params)
        lc, _, gc = vae_loop.loss_and_grads(loss_fn, vae, params, x, None,
                                            0.2, 0.5, train=False)
        lg, _, gg = vae_loop.loss_and_grads(loss_fn, vae, card, x.to(dev),
                                            None, 0.2, 0.5, train=False)
        loss_err = abs(float(lg) - float(lc)) / abs(float(lc))
        grad_err = max(float((g.cpu() - w).abs().max() / w.abs().max())
                       for g, w in zip(tree_util.leaves(gg),
                                       tree_util.leaves(gc)))
        _check(loss_err <= CF_LOSS_RTOL and grad_err <= CF_GRAD_TOL,
               f"{model} on the card vs the CPU: loss {loss_err:.2e} "
               f"(tolerance {CF_LOSS_RTOL}), gradients {grad_err:.2e} "
               f"({CF_GRAD_TOL})")
        out[model] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err}
    # one eval batch: the same logits on both devices, then each device's
    tr, te = data.vad_tr[:CF_BATCH], data.vad_te[:CF_BATCH]
    with torch.no_grad():
        logits = apply(params, torch.from_numpy(vae_loop.dense_rows(
            tr, np.arange(CF_BATCH))))[0]
    def given(z, x, train=False):              # the logits as the model's
        return z, None

    same = [vae_loop.make_eval_fn(given, True, CF_BATCH, d)(
        logits.to(d), tr, te) for d in ("cpu", dev)]
    own = [vae_loop.make_eval_fn(apply, True, CF_BATCH, d)(p, tr, te)
           for d, p in (("cpu", params), (dev, card))]
    for name, (a, b), tol in (("same logits", same, CF_METRIC_TOL),
                              ("own logits", own, CF_SCORE_TOL)):
        err = max(abs(a[k] - b[k]) for k in ("ndcg@100", "recall@20",
                                             "recall@50"))
        _check(a["eval_users"] == b["eval_users"] and err <= tol,
               f"eval metrics, {name}, card vs CPU: {err:.2e} (tolerance "
               f"{tol}): {a} / {b}")
        out[f"metrics_{name.replace(' ', '_')}_err"] = err
    out["metrics"] = own[1]
    return out


def _cf_learning_run(tmp: str, dev) -> dict:
    """``train_vae --device=cuda`` on the planted synthetic set at full
    item width (``CF_LEARN_USERS`` users: a dense [U, I] float64 host array
    of the generator is ~1 GB), ``CF_LEARN_EPOCHS`` epochs; meanwhile the
    same data is built here and ranked at random for the baseline."""
    from recsys_tpu_torch.data import movielens as ML
    from recsys_tpu_torch.train import vae_loop
    from recsys_tpu_torch.train.summaries import read_scalars

    seed = vae_loop.VaeTrainConfig().seed
    built: list = []
    maker = threading.Thread(target=lambda: built.append(
        ML.preprocess_vae_cf(*ML.synthetic_interactions(
            CF_LEARN_USERS, CF_ITEMS, seed=seed),
            n_heldout_users=CF_LEARN_HELDOUT)), daemon=True)
    maker.start()
    model_dir = os.path.join(tmp, "vae_cli")
    t0 = time.perf_counter()
    rc, out = _run_cli("train_vae", [
        "--device=cuda", "--model=multi_vae",
        f"--synthetic_users={CF_LEARN_USERS}",
        f"--synthetic_items={CF_ITEMS}",
        f"--n_heldout_users={CF_LEARN_HELDOUT}",
        f"--epochs={CF_LEARN_EPOCHS}", f"--batch_size={CF_BATCH}",
        f"--model_dir={model_dir}"], timeout=600)
    wall = time.perf_counter() - t0
    maker.join(600)
    _check(rc == 0 and bool(built), f"train_vae exited {rc}")
    result = json.loads([l for l in out.splitlines()
                         if l.startswith("{")][-1])
    _check(set(result) == {"best_ndcg", "best_epoch", "best_step", "test"},
           f"train_vae's JSON line: {result}")
    scalars = read_scalars(model_dir)
    _check(len(scalars) == CF_LEARN_EPOCHS
           and all("ndcg@100" in s and "loss" in s for s in scalars)
           and os.path.isfile(os.path.join(model_dir, "best", "meta.json")),
           f"train_vae's model_dir: {sorted(os.listdir(model_dir))}")
    data = built[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def at_random(_, x, train=False):
        return torch.rand(x.shape, generator=gen, device=dev)

    rand = vae_loop.make_eval_fn(at_random, False, CF_BATCH, dev)(
        None, data.vad_tr, data.vad_te)
    _check(result["best_ndcg"] > rand["ndcg@100"],
           f"best validation NDCG@100 {result['best_ndcg']:.4f} does not "
           f"beat a random ranking's {rand['ndcg@100']:.4f}")
    return {"result": result, "random_ndcg": rand["ndcg@100"],
            "wall_s": wall, "items": data.n_items,
            "train_users": data.train.shape[0],
            "interactions": int(data.train.nnz + data.vad_tr.nnz
                                + data.vad_te.nnz + data.test_tr.nnz
                                + data.test_te.nnz),
            "val_ndcg": [s["ndcg@100"] for s in scalars]}


def _cdae_run(dev) -> dict:
    """CDAE at ML-100K's shape on the card: SuccessRate@{1,5,10} against a
    random ranking of the unwatched items, and the epoch's ms."""
    from recsys_tpu_torch.data import movielens as ML
    from recsys_tpu_torch.models import cdae
    from recsys_tpu_torch.train import metrics as M

    users, train_x, _, test_x = ML.synthetic_ml100k(CDAE_USERS, CDAE_ITEMS,
                                                    seed=0)
    cdae.train_cdae(train_x, users, hidden=CDAE_HIDDEN, epochs=1,
                    device=dev)                                   # warm-up
    t0 = time.perf_counter()
    params, apply, losses = cdae.train_cdae(
        train_x, users, hidden=CDAE_HIDDEN, epochs=CDAE_EPOCHS, device=dev)
    epoch_ms = (time.perf_counter() - t0) * 1e3 / CDAE_EPOCHS
    rng = np.random.default_rng(7)      # not the generator's seed + 1 stream
    sr, rand = {}, {}
    for n in (1, 5, 10):
        sr[n] = M.success_rate_at_n(
            cdae.predict_topn(apply, params, train_x, users, n), test_x)
        noise = rng.random(train_x.shape) * (train_x == 0)
        rand[n] = M.success_rate_at_n(np.argsort(noise, axis=1)[:, -n:],
                                      test_x)
    _check(np.isfinite(losses).all() and losses[-1] < losses[0]
           and sr[10] > rand[10],
           f"CDAE: losses {losses[0]:.4f} → {losses[-1]:.4f}, SR@10 "
           f"{sr[10]:.2f} against random {rand[10]:.2f}")
    return {"success_rate": sr, "random_success_rate": rand,
            "epoch_ms": epoch_ms, "loss": [losses[0], losses[-1]]}


def _cavi_run(dev) -> dict:
    """`vi_gmm.fit_from` on the card from the CPU's initial state: the same
    stopping sweep, the means within ``CAVI_TOL``."""
    from recsys_tpu_torch.extras import vi_gmm

    gen = torch.Generator().manual_seed(0)
    data = vi_gmm.sample_gmm(gen, CAVI_MEANS, 1.0, CAVI_PER_CLUSTER,
                             device="cpu")
    state = vi_gmm.init_state(gen, data, len(CAVI_MEANS))
    t0 = time.perf_counter()
    cpu = vi_gmm.fit_from(data, state, epsilon=CAVI_EPS, max_iters=500)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    data, state = data.to(dev), vi_gmm.GmmState(*(t.to(dev) for t in state))
    vi_gmm.fit_from(data, state, epsilon=CAVI_EPS, max_iters=2)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = vi_gmm.fit_from(data, state, epsilon=CAVI_EPS, max_iters=500)
    card_ms = (time.perf_counter() - t0) * 1e3
    err = float((card.m.cpu() - cpu.m).abs().max())
    _check(int(card.it) == int(cpu.it) < 500 and err <= CAVI_TOL,
           f"CAVI: the card stopped at sweep {int(card.it)}, the CPU at "
           f"{int(cpu.it)}; means within {err:.2e} (tolerance {CAVI_TOL})")
    return {"sweeps": int(card.it), "means": sorted(card.m.cpu().tolist()),
            "mean_err": err, "card_ms": card_ms, "cpu_ms": cpu_ms}


def cf_phase(dev, wrappers: tuple, card: str) -> dict:
    """The CF family on the card (see the module docstring, item 11).
    ``wrappers``: the kernel wrappers' modules, whose launch counts must
    not move."""
    from recsys_tpu_torch.train import vae_loop

    def launches():
        return {f"{m.__name__}.{k}": v for m in wrappers
                for k, v in vars(m).items() if k.endswith("LAUNCHES")}

    t_phase = time.perf_counter()
    before = launches()
    with tempfile.TemporaryDirectory() as tmp:
        # the learning run (a subprocess on the card) while this process
        # builds the ML-20M-shaped set on the host; nothing is timed on the
        # card until both are done
        learned: dict = {}

        def learn():
            try:
                learned["out"] = _cf_learning_run(tmp, dev)
            except BaseException as e:          # re-raised below
                learned["err"] = e

        learner = threading.Thread(target=learn, daemon=True)
        learner.start()
        t0 = time.perf_counter()
        data = ml20m_shaped(seed=0)
        build_s = time.perf_counter() - t0
        nnz = sum(m.nnz for m in (data.train, data.vad_tr, data.vad_te,
                                  data.test_tr, data.test_te))
        learner.join(900)
        if "err" in learned:
            raise learned["err"]
        _check("out" in learned, "the CF learning run did not finish")
        learn = learned["out"]
        cfg = vae_loop.VaeTrainConfig(model="multi_vae", epochs=1,
                                      model_dir=os.path.join(tmp, "vae"))
        t0 = time.perf_counter()
        epoch = vae_loop.train_vae_cf(data, cfg, device=dev)
        epoch_s = time.perf_counter() - t0
        _check(np.isfinite(epoch["test"]["ndcg@100"])
               and epoch["test"]["eval_users"] > 0
               and os.path.isdir(os.path.join(cfg.model_dir, "best")),
               f"one multi_vae epoch at ML-20M's shape: {epoch}")
        steps = _cf_steps(data, cfg, dev)
    vs_cpu = _cf_card_vs_cpu(data, dev)
    cd = _cdae_run(dev)
    cavi = _cavi_run(dev)
    _check(launches() == before,
           f"the CF path launched a kernel of the port's: {before} → "
           f"{launches()}")
    out = {"data": {"users": CF_USERS, "items": CF_ITEMS,
                    "interactions": nnz, "train_users": data.train.shape[0],
                    "build_s": build_s},
           "epoch": {"wall_s": epoch_s, "steps": -(-data.train.shape[0]
                                                   // CF_BATCH),
                     "result": epoch},
           "steps": steps, "learning": learn, "card_vs_cpu": vs_cpu,
           "cdae": cd, "cavi": cavi,
           "phase_s": time.perf_counter() - t_phase, "card": card}
    s = steps
    print(f"CF [{card}]: ML-20M-shaped data ({CF_USERS} users x {CF_ITEMS} "
          f"items, {nnz} interactions, built in {build_s:.1f} s beside the "
          "learning run); one "
          f"multi_vae epoch of {out['epoch']['steps']} steps at batch "
          f"{CF_BATCH} with validation, checkpoint and test in "
          f"{epoch_s:.2f} s (test NDCG@100 {epoch['test']['ndcg@100']:.4f}); "
          f"a step (median [min, max] of {CF_TIMED_STEPS}): "
          f"{s['step_ms'][0]:.3f} {s['step_ms'][1:]} ms = host densify "
          f"{s['densify_ms'][0]:.3f} + copy {s['copy_ms'][0]:.3f} + device "
          f"{s['device_ms'][0]:.3f} (CUDA events) ms, {s['users_per_s']:.0f} "
          f"users/s; profiled: busy {s['busy_ms']:.4f} ms a step (the "
          f"pageable copy {s['copy_busy_ms']:.4f}), {s['device_ops']:.1f} "
          f"device ops, idle share {s['idle_share']:.3f} ("
          f"{s['compute_idle_share']:.3f} without the copy), top "
          f"{s['top']}; eval "
          f"{s['eval_ms_per_batch']:.3f} ms a batch of {CF_BATCH}",
          flush=True)
    print(f"CF learning run [{card}]: train_vae --device=cuda at "
          f"{learn['items']} items, {learn['train_users']} training users, "
          f"{learn['interactions']} interactions, {CF_LEARN_EPOCHS} epochs "
          f"in {learn['wall_s']:.1f} s: validation NDCG@100 by epoch "
          f"{['%.4f' % v for v in learn['val_ndcg']]}, best "
          f"{learn['result']['best_ndcg']:.4f} (epoch "
          f"{learn['result']['best_epoch']}) against a random ranking's "
          f"{learn['random_ndcg']:.4f}; test {learn['result']['test']}; "
          "card vs CPU (loss, gradients relative to the leaf's largest): "
          + ", ".join(f"{m} {v['loss_rel_err']:.2e} / {v['grad_rel_err']:.2e}"
                      for m, v in vs_cpu.items() if m in (
                          "multi_dae", "multi_vae", "logistic_vae"))
          + f"; eval metrics from one set of logits within "
          f"{vs_cpu['metrics_same_logits_err']:.2e}, from each device's own "
          f"{vs_cpu['metrics_own_logits_err']:.2e}; CDAE {CDAE_USERS} x "
          f"{CDAE_ITEMS} hidden {CDAE_HIDDEN}: SuccessRate@1/5/10 "
          + "/".join(f"{cd['success_rate'][n]:.2f}" for n in (1, 5, 10))
          + " (random "
          + "/".join(f"{cd['random_success_rate'][n]:.2f}" for n in (1, 5, 10))
          + f"), {cd['epoch_ms']:.2f} ms an epoch; CAVI "
          f"{len(CAVI_MEANS) * CAVI_PER_CLUSTER} points: {cavi['sweeps']} "
          f"sweeps on the card as on the CPU, means "
          f"{['%.4f' % m for m in cavi['means']]} within "
          f"{cavi['mean_err']:.2e}, {cavi['card_ms']:.1f} ms (CPU "
          f"{cavi['cpu_ms']:.1f}); CF phase {out['phase_s']:.1f} s",
          flush=True)
    print(json.dumps({"cf": out}, default=str), flush=True)
    return out


SAMPLER_ROWS = 1 << 20         # the sampler's marginals: rows drawn
SAMPLER_BATCH = 16384
SAMPLER_STEPS = 40             # graphed against eager, from one state
SAMPLER_WARMUP = 20            # the cosine schedule's warm-up, inside
SHORT_EXAMPLES = 50_000_000    # the short protocol run (DeepFM)
SHORT_EVAL_ROWS = 262_144


def converge_phase(ccfg, dev, rg, ss, card: str) -> dict:
    """The convergence protocol's path on the card (see the module
    docstring, item 12): the sampler's marginals, the sampler K-step call
    graphed against eager at full width, its launches and ex/s beside the
    devgen step's, and a short protocol run above its slice's linear
    ceiling. → numbers of the run."""
    from recsys_tpu_torch.core import tree
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.data import synthetic_device as sd
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.tools import converge
    from recsys_tpu_torch.tools.profile_step import profile_call
    from recsys_tpu_torch.train import fast, optim
    from recsys_tpu_torch.train import train_state as TS

    t_phase = time.perf_counter()
    # the short run's ceilings on the host, beside the card's work
    ceil: dict = {}

    def ceilings():
        try:
            ceil["out"] = converge.ceilings(SHORT_EVAL_ROWS)
        except BaseException as e:              # re-raised below
            ceil["err"] = e

    host = threading.Thread(target=ceilings, daemon=True)
    host.start()

    tables = sd.device_tables(sd.planted_tables(ccfg), dev)
    sample = sd.make_device_sampler(ccfg)
    b = sample(torch.Generator(dev).manual_seed(0), tables, SAMPLER_ROWS)
    ref = synthetic_criteo(SAMPLER_ROWS, ccfg, start_row=999_999)
    vocabs = np.asarray(ccfg.field_vocab_sizes)
    dev_ids = b["ids"].double().mean(dim=0).cpu().numpy()
    id_err = np.abs(dev_ids - ref["ids"].mean(axis=0)) / vocabs
    marg = {"label": (float(b["label"].mean()), float(ref["label"].mean())),
            "dense": (float(b["dense"].mean()), float(ref["dense"].mean())),
            "max_id_mean_err_over_vocab": float(id_err.max())}
    _check(abs(marg["label"][0] - marg["label"][1]) < 0.01
           and abs(marg["dense"][0] - marg["dense"][1]) < 0.01
           and bool((np.abs(dev_ids - ref["ids"].mean(axis=0))
                     < 0.03 * vocabs + 0.5).all())
           and bool((b["ids"].max(dim=0).values.cpu().numpy()
                     < vocabs).all()),
           f"the device sampler's marginals against the host generator's: "
           f"{marg}")
    del b, ref

    model = make_model("deepfm", ccfg, ModelConfig(name="deepfm"))
    # the schedule spans every step the sampler's state takes here
    total = SAMPLER_STEPS + 10 + GRAPH_PAIRS * K
    counters = {"segment_sum": ss, "row_gather": rg}
    runs = {}
    for mode in ("eager", "graphed"):
        opt = optim.adam(optim.cosine_decay(6e-3, total,
                                            warmup_steps=SAMPLER_WARMUP))
        ts, tx = TS.create_train_state(model, 0, 6e-3, dev, opt=opt)
        fn = fast.make_scanned_train_step_sampler(
            model, tx, sample, SAMPLER_BATCH, graphed=mode == "graphed")
        torch.cuda.synchronize()
        _zero(counters)                   # the sampler path starts here
        ts, loss = fn(ts, tables, SAMPLER_STEPS, 0)
        float(loss)
        counts = _read(counters)          # ... and ends here
        runs[mode] = {"ts": ts, "fn": fn, "loss": loss, "counts": counts}
    leaves = [tree.leaves((r["ts"].params, r["ts"].model_state,
                           r["ts"].opt_state)) for r in runs.values()]
    diff = max(float((x - y).abs().max()) for x, y in zip(*leaves))
    g = runs["graphed"]
    _check(diff <= GRAPH_TOL
           and torch.equal(runs["eager"]["loss"], g["loss"]),
           f"the sampler step: after {SAMPLER_STEPS} steps graphed and eager "
           f"differ by {diff}, mean losses {float(runs['eager']['loss'])} "
           f"and {float(g['loss'])}")
    _check(g["counts"] == {"segment_sum": 2 * SAMPLER_STEPS,
                           "row_gather": 2 * SAMPLER_STEPS},
           f"the sampler step's launches {g['counts']} for {SAMPLER_STEPS} "
           f"steps, want {2 * SAMPLER_STEPS} each")
    g["ts"], prof = profile_call(g["fn"], g["ts"], tables, SAMPLER_STEPS)
    _check(round(prof["graph_launches_per_step"], 6) == 1.0,
           f"the sampler step: {prof['graph_launches_per_step']} graph "
           "launches a step, want 1")

    # ex/s of the sampler step beside the devgen step, alternating
    data = synthetic_criteo(16 * SAMPLER_BATCH, ccfg)
    staged = fast.stage_dataset(data, dev)
    ts_d, tx_d = TS.create_train_state(model, 0, 6e-3, dev, opt=optim.adam(
        optim.cosine_decay(6e-3, total, warmup_steps=SAMPLER_WARMUP)))
    devgen = fast.make_scanned_train_step_devgen(
        model, tx_d, len(data["label"]), SAMPLER_BATCH)
    ts_d, loss = devgen(ts_d, staged, K, 0)            # the capture
    float(loss)
    done = {"sampler": SAMPLER_STEPS + 10, "devgen": K}
    ex_s = {"sampler": [], "devgen": []}
    for p in range(GRAPH_PAIRS):
        for mode in (("sampler", "devgen") if p % 2 == 0
                     else ("devgen", "sampler")):
            t0 = time.perf_counter()
            if mode == "sampler":
                g["ts"], loss = g["fn"](g["ts"], tables, K, done[mode])
            else:
                ts_d, loss = devgen(ts_d, staged, K, done[mode])
            float(loss)
            ex_s[mode].append(SAMPLER_BATCH * K
                              / (time.perf_counter() - t0))
            done[mode] += K
    del staged, ts_d, runs

    # the short protocol run: DeepFM from the JAX run's initial weights
    short = converge.converge_ctr("deepfm", examples=SHORT_EXAMPLES,
                                  batch=SAMPLER_BATCH, device=dev,
                                  eval_rows=SHORT_EVAL_ROWS)
    host.join(600)
    if "err" in ceil:
        raise ceil["err"]
    _check("out" in ceil, "the short run's ceilings did not finish")
    lin = ceil["out"]["linear_ceiling"]["auc"]
    ido = ceil["out"]["idonly_ceiling"]["auc"]
    _check(short["auc"] > lin,
           f"the short protocol run: DeepFM AUC {short['auc']} is not above "
           f"the slice's linear ceiling {lin}")
    out = {"marginals": marg, "max_abs_diff": diff,
           "counts": g["counts"], "steps": SAMPLER_STEPS,
           "graph_launches_per_step": prof["graph_launches_per_step"],
           "launch_calls_per_step": prof["launch_calls_per_step"],
           "busy_ms_per_step": prof["device_busy_ms_per_step"],
           "ex_s": ex_s, "short": short,
           "ceilings": ceil["out"], "phase_s": time.perf_counter() - t_phase,
           "card": card}
    print(f"converge [{card}]: the device sampler's marginals on "
          f"{SAMPLER_ROWS} rows against the host generator's: label rate "
          f"{marg['label'][0]:.4f} / {marg['label'][1]:.4f}, dense mean "
          f"{marg['dense'][0]:.4f} / {marg['dense'][1]:.4f}, largest id-mean "
          f"gap {marg['max_id_mean_err_over_vocab']:.4f} of its vocab; the "
          f"sampler step (DeepFM, batch {SAMPLER_BATCH}, dropout 0.5, warm-up "
          f"{SAMPLER_WARMUP} of a cosine schedule) graphed equal to eager "
          f"after {SAMPLER_STEPS} steps (max |diff| {diff}, the same mean "
          f"loss), launches {g['counts']}, "
          f"{prof['graph_launches_per_step']:.1f} graph launch and "
          f"{prof['launch_calls_per_step']:.1f} kernel launch calls a step, "
          f"busy {prof['device_busy_ms_per_step']:.4f} ms a step; ex/s in "
          f"alternating pairs of {K}-step calls: sampler "
          f"{['%.0f' % x for x in ex_s['sampler']]}, devgen "
          f"{['%.0f' % x for x in ex_s['devgen']]}; short protocol run "
          f"(DeepFM, {short['examples']} examples): AUC {short['auc']:.4f} "
          f"against the slice's linear ceiling {lin:.4f} and id-only "
          f"{ido:.4f}, {short['train_examples_per_s']:.0f} ex/s; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def _avazu_like_csv(path: str, n: int, seed: int = 0) -> None:
    """An Avazu-format click log whose clicks depend on the site and app
    (the classical tests' planted CSV)."""
    rng = np.random.default_rng(seed)
    site_eff = rng.normal(0, 1.2, 20)
    app_eff = rng.normal(0, 1.2, 15)
    with open(path, "w") as f:
        f.write("id,click,hour,site,app,device\n")
        for i in range(n):
            site, app = rng.integers(0, 20), rng.integers(0, 15)
            day = rng.integers(1, 12)
            logit = -0.5 + site_eff[site] + app_eff[app]
            y = int(rng.random() < 1 / (1 + np.exp(-logit)))
            f.write(f"{i},{y},1410{day:02d}{rng.integers(0, 24):02d},"
                    f"s{site},a{app},d{rng.integers(0, 5)}\n")


def classical_phase() -> dict:
    """The classical models on the card's host (see the module docstring,
    item 13): FTRL-proximal on a planted CSV; GBDT+LR where scikit-learn
    imports, else a line that says it was not run and why."""
    import importlib.util

    from recsys_tpu_torch.models import ftrl_lr as F

    t_phase = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.csv")
        _avazu_like_csv(path, 20_000)
        t0 = time.perf_counter()
        learner, val = F.train_csv(path, epochs=2, holdafter=8, D=2 ** 18,
                                   alpha=0.3)
        ys = []
        with open(path) as f:
            next(f)
            for line in f:
                fields = line.split(",")
                if int(fields[2][4:6]) > 8:
                    ys.append(float(fields[1]))
        base = float(np.mean(ys))
        base_ll = -(base * np.log(base) + (1 - base) * np.log(1 - base))
        out["ftrl"] = {"val_logloss": val, "base_logloss": base_ll,
                       "seconds": time.perf_counter() - t0}
    _check(np.isfinite(val) and val < base_ll,
           f"FTRL: held-out logloss {val} against the base rate's {base_ll}")
    if importlib.util.find_spec("sklearn") is None:
        out["gbdt"] = "not run: scikit-learn (sklearn) does not import here"
    else:
        from recsys_tpu_torch.tools import gbdt_fe
        res = gbdt_fe.main(["--synthetic_rows=2000", "--n_trees=20",
                            "--num_leaves=15"])
        _check(res["gbdt_lr"]["nce"] < 1.0, f"GBDT+LR: {res}")
        out["gbdt"] = res
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"classical, on the host: FTRL on a planted 20,000-row CSV, "
          f"held-out logloss {val:.4f} against the base rate's "
          f"{base_ll:.4f} ({out['ftrl']['seconds']:.1f} s); GBDT+LR: "
          + (out["gbdt"] if isinstance(out["gbdt"], str)
             else f"NCE {out['gbdt']['gbdt_lr']['nce']:.4f}")
          + f"; phase {out['phase_s']:.1f} s", flush=True)
    return out


def tools_phase() -> dict:
    """``tools/results.py`` and ``tools/bench_stream.py`` from the command
    line on the card, tiny, into a temporary directory (see the module
    docstring, item 14)."""
    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        code, _ = _run_cli("results", [
            "--device=cuda", "--models=fm", "--batch=4096", "--steps=100",
            "--rows=65536", "--din=0", "--cf=0", "--serving=0",
            f"--workdir={tmp}/w", f"--out={tmp}/R.md"], 600)
        _check(code == 0, f"results exited with {code}")
        with open(f"{tmp}/R.json") as f:
            res = json.load(f)
        out["results_fm"] = res["ctr"][0]
        code, _ = _run_cli("bench_stream", [
            "--device=cuda", "--rows=131072", "--batch=8192",
            "--train_steps=50", f"--workdir={tmp}/s", f"--out={tmp}/S.md"],
            600)
        _check(code == 0, f"bench_stream exited with {code}")
        with open(f"{tmp}/S.json") as f:
            out["bench_stream"] = json.load(f)
    r, s = out["results_fm"], out["bench_stream"]
    _check(r["train_examples_per_s"] > 0 and 0.5 < r["auc"] <= 1.0
           and s["s4_stream_train_examples_per_s"] > 0
           and r["device_label"] == s["device_label"] != "cpu",
           f"tools: {out}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"tools from the command line [{r['device_label']}]: results, FM "
          f"one epoch of 65,536 rows at batch 4096: AUC {r['auc']:.4f}, "
          f"{r['train_examples_per_s']:.0f} train ex/s; bench_stream at "
          f"131,072 rows, batch 8192: s1 {s['s1_preprocess_rows_per_s']:.0f}"
          f" rows/s, s2 {s['s2_host_pipeline_rows_per_s']:.0f}, s3 "
          f"{s['s3_h2d_rows_per_s']:.0f}, s4 "
          f"{s['s4_stream_train_examples_per_s']:.0f} ex/s against devgen "
          f"{s['devgen_examples_per_s']:.0f}; phase {out['phase_s']:.1f} s",
          flush=True)
    return out


def main() -> None:
    spmd_only = sys.argv[1:] == ["--spmd-only"]
    if sys.argv[1:] and not spmd_only:
        raise SystemExit("usage: python3 chip_smoke.py [--spmd-only]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    sys.path.insert(0, ROOT)
    from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
    from recsys_tpu_torch.data.criteo import synthetic_criteo
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB
    from recsys_tpu_torch.ops import adam_update as au
    from recsys_tpu_torch.ops import cin_kernel, cuda_build
    from recsys_tpu_torch.ops import din_attention as da
    from recsys_tpu_torch.ops import reshape_probe as rp
    from recsys_tpu_torch.ops import row_gather as rg
    from recsys_tpu_torch.ops import segment_sum as ss
    from recsys_tpu_torch.serve.export import export_servable
    from recsys_tpu_torch.utils.profiling import card as card_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_of(torch.device("cuda", 0))
    print(card, flush=True)   # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    sources = [cin_kernel.SOURCE, cin_kernel.BWD_SOURCE, ss.SOURCE, rg.SOURCE,
               rp.SOURCE, au.SOURCE, da.SOURCE]
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
    if spmd_only:
        _report_spmd(spmd_phase(ccfg, dev, rg, ss), card)
        return
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
    adam = adam_update_phase(au, ccfg, dev)
    din_attn = din_attention_phase(da, dev)
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
          f"{probe['2d']['library_ms']:.4f} ms of device time; Adam "
          f"{adam['deepfm']['ms']:.4f} / {adam['xdeepfm']['ms']:.4f} ms vs "
          f"plain {adam['deepfm']['plain_ms']:.4f} / "
          f"{adam['xdeepfm']['plain_ms']:.4f} ms of device time (DeepFM's / "
          "xDeepFM's tree)", flush=True)

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
    sp = spmd_phase(ccfg, dev, rg, ss)
    _report_spmd(sp, card)
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
    cf_phase(dev, (cin_kernel, ss, rg, rp), card)
    conv = converge_phase(ccfg, dev, rg, ss, card)
    classical = classical_phase()
    tools = tools_phase()
    print(json.dumps({"converge": conv, "classical": classical,
                      "tools": tools}, default=str), flush=True)
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
                 f"{stream['counts']['segment_sum']}; converge_launches: "
                 f"the sampler K-step call, DeepFM, {SAMPLER_STEPS} graphed "
                 "steps (2 a step)",
         "launches": fused["segment_sum"],
         "converge_launches": conv["counts"]["segment_sum"],
         "owner_gather": dict(
             sp["k2"], launches=sp["counts"]["segment_sum"],
             note="the sharded lookup's owner gather, the :154 contract's "
                  "third caller, at one member on DeepFM's big table at "
                  "B=16384 (E*cap ids, most of them the unused slots' "
                  "row 0 with zero gradients); launches: "
                  f"{SPMD_STEPS} SPMD DeepFM steps, with the small "
                  "table's sum (2 a step)"),
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
                 "version is the library call, index_select; "
                 f"converge_launches: the sampler K-step call, DeepFM, "
                 f"{SAMPLER_STEPS} graphed steps (2 a step)",
         "launches": din["counts"]["row_gather"],
         "converge_launches": conv["counts"]["row_gather"],
         "owner_gather": dict(
             sp["s1"], launches=sp["counts"]["row_gather"],
             note="the sharded lookup's owner gather's forward at one "
                  "member on DeepFM's big table at B=16384; launches: "
                  f"{SPMD_STEPS} SPMD DeepFM steps, with the small "
                  "table's read (2 a step)"),
         "serving_launches": {name: sv["launches"]["row_gather"]
                              for name, sv in served.items()},
         **{k: gat[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "shapes")}},
    ] + [
        {"name": name, "route": "cuda",
         "source": "recsys_tpu_torch/csrc/reshape_probe.cu",
         "replaces": f"scratch/mosaic_reshape_test.py:{line}",
         "note": "a compiler probe no path reaches: launches from the probe "
                 "phase's own run; ms, plain_ms, library_ms: device time a "
                 "call in a CUDA graph of 100, the median of "
                 f"{PROBE_ROUNDS} interleaved rounds with the same buffers "
                 f"(median_min_max: hot and rotated) at VP={PROBE_ROWS}, "
                 f"W={PROBE_W}; library: torch.mul(x, 2.0)",
         **probe[key]}
        for name, key, line in (("reshape_probe_flat", "flat", 18),
                                ("reshape_probe_2d", "2d", 33))] + [
        {"name": "adam_update", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/adam_update.cu", "replaces": None,
         "note": "replaces no TPU kernel (XLA fuses the JAX package's "
                 "Adam); ms, plain_ms: device time a call in a CUDA graph "
                 f"of {ADAM_TIMED} at DeepFM's tree (trees: each tree's); "
                 "no library call computes TF-parity Adam; launches, "
                 "leaves: DeepFM training, one launch a step over every "
                 "leaf; elsewhere: " + ", ".join(
                     f"{k} {v['counts']['adam']} ({v['counts']['adam_leaves']}"
                     " leaves)" for k, v in trained.items()),
         "launches": trained["DeepFM"]["counts"]["adam"],
         "leaves": trained["DeepFM"]["counts"]["adam_leaves"],
         "trees": adam,
         **{k: adam["deepfm"][k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}},
        {"name": "din_attention", "route": "cuda",
         "source": "recsys_tpu_torch/csrc/din_attention.cu",
         "replaces": None,
         "note": "replaces no TPU kernel (XLA fuses the JAX package's DIN "
                 "unit); seven kernels round the unit's cuBLAS products; "
                 "kernels: each one's device ms a call in a CUDA graph of "
                 f"{DIN_UNIT_TIMED} at the DIN cell's shapes {DIN_UNIT}, "
                 "plain_ms its plain version's, host_ms back to back; "
                 "unit: one unit's forward and backward, the Function "
                 "against autograd over the plain unit; launches: DIN "
                 "training (8 a unit a step, 4 an eval batch)",
         "launches": din["counts"]["din_attention"],
         "kernels": din_attn}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
