"""The port on the card: the CUDA kernels (CIN forward and backward,
segment sum, row gather, the reshape probes, Adam's update) against their
plain versions
at the shapes of full-width xDeepFM, DeepFM, DIN and the fused engine,
autograd through them, servables on the card against the same servables on
the CPU, and training steps of the zoo on the card against the same steps
on the CPU. Every test here is marked ``gpu`` and skips
without a CUDA device (the kernels have no CPU mode). This file imports
neither jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance 1e-4 absolute and relative unless a test says otherwise: float32
sums of up to 1521 terms, taken in another order than cuBLAS takes them.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data.criteo import synthetic_criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.data import amazon
from recsys_tpu_torch.ops import adam_update as au
from recsys_tpu_torch.ops import cin_kernel, cuda_build
from recsys_tpu_torch.ops import reshape_probe as rp
from recsys_tpu_torch.ops import row_gather as rg
from recsys_tpu_torch.ops import segment_sum as ss
from recsys_tpu_torch.serve.export import Servable, export_servable
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import train_state as TS

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [16, 3333, 16 * 4096])
@pytest.mark.parametrize("fk,h", [(39, 20), (20, 10), (10, 10)])
def test_kernel_matches_plain_version(cuda_device, n, fk, h):
    gen = torch.Generator().manual_seed(n + fk)
    x0v = torch.randn(n, 39, generator=gen).to(cuda_device)
    xkv = torch.randn(n, fk, generator=gen).to(cuda_device)
    w = (0.05 * torch.randn(39 * fk, h, generator=gen)).to(cuda_device)
    b = torch.randn(h, generator=gen).to(cuda_device)
    before = _count("cin_fwd")
    got = cin_kernel.cin_layer(x0v, xkv, w, b)
    torch.cuda.synchronize()
    assert _count("cin_fwd") == before + 1
    torch.testing.assert_close(
        got, cin_kernel.cin_layer_reference(x0v, xkv, w, b),
        rtol=1e-4, atol=1e-4)


def test_kernel_refuses_bad_inputs_on_the_card(cuda_device):
    x0v = torch.randn(32, 39, device=cuda_device)
    w, b = torch.randn(39 * 39, 20, device=cuda_device), torch.zeros(20)
    with pytest.raises(ValueError, match="is on"):
        cin_kernel.cin_layer(x0v, x0v, w, b)               # b on the CPU
    with pytest.raises(TypeError):
        cin_kernel.cin_layer(x0v.half(), x0v.half(), w, b.to(cuda_device))


def _fwd_inputs(dev, n, f0, fk, h, seed):
    gen = torch.Generator().manual_seed(seed)
    lim = (6.0 / (f0 * fk + h)) ** 0.5
    x0v = torch.randn(n, f0, generator=gen).to(dev)
    xkv = torch.randn(n, fk, generator=gen).to(dev)
    w = torch.empty(f0 * fk, h).uniform_(-lim, lim, generator=gen).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    return x0v, xkv, w, b


def _assert_fwd_matches_and_repeats(args):
    """The kernel within 1e-4 absolute and relative of the plain version,
    and bitwise equal across two calls (one writer per output)."""
    got = cin_kernel.cin_layer_fwd(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, cin_kernel.cin_layer_reference(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, cin_kernel.cin_layer_fwd(*args))


@pytest.mark.parametrize("h", [1, 3, 10, 13, 20, 32])
@pytest.mark.parametrize("fk", [10, 39])
def test_cin_forward_kernel_at_every_width(cuda_device, fk, h):
    """H off and on a multiple of 4 (each W row padded to a float4 count)
    over the whole range, at a ragged N; (39, 39, 32) is a W too large to
    sit beside the row tiles, staged in chunks of p."""
    _assert_fwd_matches_and_repeats(
        _fwd_inputs(cuda_device, 3333, 39, fk, h, seed=fk * 100 + h))


@pytest.mark.parametrize("n", [0, 1, 16, 127, 129, 3333, 16 * 4096])
@pytest.mark.parametrize("h", [10, 20])
def test_cin_forward_kernel_at_small_and_ragged_n(cuda_device, n, h):
    """N = 0 (no launch), one row, a serving request's 16 rows, one less and
    one more than a 128-row tile, a ragged N, and the training N, where each
    block walks several tiles."""
    args = _fwd_inputs(cuda_device, n, 39, 20, h, seed=n + h)
    before = _count("cin_fwd")
    _assert_fwd_matches_and_repeats(args)
    assert _count("cin_fwd") == before + 2 * (n > 0)


@pytest.mark.parametrize("f0,fk,h", [(5, 3, 4), (1, 1, 1), (64, 7, 6),
                                     (200, 100, 8), (200, 200, 32),
                                     (150, 150, 20), (150, 271, 13),
                                     (201, 249, 1)])
def test_cin_forward_kernel_at_other_field_counts(cuda_device, f0, fk, h):
    """Field counts other than xDeepFM's: fewer p than lanes, one field,
    an even F0; F0 + Fk too large for two tile buffers beside W (one
    buffer, W in many chunks); a step of 8 values of p too large beside one
    tile buffer (chunks of 5 and 6 values of p, lanes idle); and one value
    of p too large beside a whole tile (tiles of half the rows)."""
    _assert_fwd_matches_and_repeats(
        _fwd_inputs(cuda_device, 1000, f0, fk, h, seed=f0 + fk + h))


def test_cin_forward_kernel_reads_unaligned_rows(cuda_device):
    """Row arrays that do not start on 16 bytes (a view one row in): the
    tiles come in by 4-byte copies."""
    x0v, xkv, w, b = _fwd_inputs(cuda_device, 1001, 39, 10, 10, seed=11)
    wu = torch.empty(w.numel() + 1, device=cuda_device)[1:].view_as(w)
    args = (x0v[1:], xkv[1:], wu.copy_(w), b)
    assert all(t.data_ptr() % 16 for t in args[:3])
    _assert_fwd_matches_and_repeats(args)


@pytest.mark.parametrize("fk,h", [(39, 20), (20, 10), (10, 10)])
def test_cin_forward_kernel_replays_in_a_cuda_graph(cuda_device, fk, h):
    """A call captured in a CUDA graph after a warm-up call, replayed on new
    inputs, equals an eager call bitwise (main-path shapes)."""
    x0v, xkv, w, b = _fwd_inputs(cuda_device, 16 * 4096, 39, fk, h,
                                 seed=fk + h)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cin_kernel.cin_layer_fwd(x0v, xkv, w, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cin_kernel.cin_layer_fwd(x0v, xkv, w, b)
    xkv.copy_(torch.randn(xkv.shape,
                          generator=torch.Generator().manual_seed(3)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, cin_kernel.cin_layer_fwd(x0v, xkv, w, b))
    torch.testing.assert_close(
        out, cin_kernel.cin_layer_reference(x0v, xkv, w, b),
        rtol=1e-4, atol=1e-4)


def test_servable_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    ccfg = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    mcfg = ModelConfig(name="xdeepfm", cin_layers=(20, 10, 10))
    params, state = make_model("xdeepfm", ccfg, mcfg).init(
        torch.Generator().manual_seed(0), "cpu")
    export_servable(str(tmp_path), "xdeepfm", params, state, mcfg, ccfg)
    d = synthetic_criteo(300, ccfg)
    feats = {"ids": d["ids"], "dense": d["dense"]}
    before = _count("cin_fwd")
    got = Servable(str(tmp_path), device="cuda").predict(feats)
    assert _count("cin_fwd") == before + 3
    ref = Servable(str(tmp_path), device="cpu").predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n", [16, 3333, 16 * 4096])
@pytest.mark.parametrize("fk,h", [(39, 20), (20, 10), (10, 10)])
def test_backward_kernel_matches_plain_version(cuda_device, n, fk, h):
    gen = torch.Generator().manual_seed(n + fk + 1)
    x0v = torch.randn(n, 39, generator=gen).to(cuda_device)
    xkv = torch.randn(n, fk, generator=gen).to(cuda_device)
    w = (0.05 * torch.randn(39 * fk, h, generator=gen)).to(cuda_device)
    b = torch.randn(h, generator=gen).to(cuda_device)
    y = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
    dy = torch.randn(n, h, generator=gen).to(cuda_device)
    before = _count("cin_bwd")
    got = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    torch.cuda.synchronize()
    assert _count("cin_bwd") == before + 1
    ref = cin_kernel.cin_layer_backward_reference(x0v, xkv, w, y, dy)
    # dW and db are sums over all N rows: the tolerance grows with them
    tol = 1e-4 * max(1.0, n / 1024)
    for name, g, r in zip(("dx0", "dxk", "dw", "db"), got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=tol, msg=name)
    again = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    for g, a in zip(got, again):
        assert torch.equal(g, a)            # deterministic: no atomics


def _bwd_inputs(dev, n, fk, h, seed):
    gen = torch.Generator().manual_seed(seed)
    x0v = torch.randn(n, 39, generator=gen).to(dev)
    xkv = torch.randn(n, fk, generator=gen).to(dev)
    w = (0.05 * torch.randn(39 * fk, h, generator=gen)).to(dev)
    b = torch.randn(h, generator=gen).to(dev)
    y = cin_kernel.cin_layer_reference(x0v, xkv, w, b)
    dy = torch.randn(n, h, generator=gen).to(dev)
    return x0v, xkv, w, y, dy


def _assert_bwd_matches(got, ref, n):
    """chip_smoke.py's tolerances: 1e-4 absolute and relative for dx0 and
    dxk; dW and db are sums over all N rows, 1e-4·N/1024 absolute."""
    for name, g, r in zip(("dx0", "dxk", "dw", "db"), got, ref):
        atol = 1e-4 * (max(1.0, n / 1024) if name in ("dw", "db") else 1.0)
        assert g.shape == r.shape, name
        torch.testing.assert_close(g, r, rtol=1e-4, atol=atol, msg=name)


@pytest.mark.parametrize("fk", [1, 10, 20, 39])
@pytest.mark.parametrize("h", [1, 10, 20, 32])
def test_cin_backward_kernel_at_every_tile_shape(cuda_device, fk, h):
    """Fk and H on and off the kernels' tiles (4 q values a lane, 8 a lane
    pair; 4 rows a thread up to H = 24, 2 above) at a ragged N."""
    n = 3333
    args = _bwd_inputs(cuda_device, n, fk, h, seed=fk * 100 + h)
    got = cin_kernel.cin_layer_bwd(*args)
    torch.cuda.synchronize()
    _assert_bwd_matches(got, cin_kernel.cin_layer_backward_reference(*args),
                        n)
    for g, a in zip(got, cin_kernel.cin_layer_bwd(*args)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("n", [0, 1, 100, 257, 3333])
def test_cin_backward_kernel_at_small_and_ragged_n(cuda_device, n):
    """N = 0 (no launch), one row, fewer rows than one block's tile (256),
    one more than a tile, and a ragged N."""
    args = _bwd_inputs(cuda_device, n, 39, 20, seed=n + 7)
    before = _count("cin_bwd")
    got = cin_kernel.cin_layer_bwd(*args)
    torch.cuda.synchronize()
    assert _count("cin_bwd") == before + (n > 0)
    _assert_bwd_matches(got, cin_kernel.cin_layer_backward_reference(*args),
                        n)
    for g, a in zip(got, cin_kernel.cin_layer_bwd(*args)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("fk,h", [(39, 20), (20, 10), (10, 10)])
def test_cin_backward_kernel_replays_in_a_cuda_graph(cuda_device, fk, h):
    """A call captured in a CUDA graph after a warm-up call, replayed on new
    output gradients, equals an eager call bitwise (main-path shapes)."""
    n = 16 * 4096
    x0v, xkv, w, y, dy = _bwd_inputs(cuda_device, n, fk, h, seed=fk + h)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    dy.copy_(torch.randn(dy.shape, generator=torch.Generator().manual_seed(3)))
    graph.replay()
    torch.cuda.synchronize()
    eager = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    for g, e in zip(out, eager):
        assert torch.equal(g, e)
    _assert_bwd_matches(out, cin_kernel.cin_layer_backward_reference(
        x0v, xkv, w, y, dy), n)


def test_cin_apply_trains_through_the_kernels(cuda_device):
    """``cin_apply`` on the card is differentiable (it was not: the forward
    kernel's output had no grad_fn), and its gradients match those of the
    plain version on the same tensors."""
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(64, 39, 16, generator=gen).to(cuda_device)
    params = []
    fk = 39
    for h in (20, 10, 10):
        params.append({"w": (0.05 * torch.randn(39 * fk, h, generator=gen)
                             ).to(cuda_device),
                       "b": torch.randn(h, generator=gen).to(cuda_device)})
        fk = h
    wts = torch.randn(64, 40, generator=gen).to(cuda_device)

    def grads(layer_fn):
        p = [{k: v.clone().requires_grad_() for k, v in l.items()}
             for l in params]
        x = x0.clone().requires_grad_()
        x0v = x.transpose(1, 2).reshape(-1, 39).contiguous()
        xkv, pooled = x0v, []
        for l in p:
            xkv = layer_fn(x0v, xkv, l["w"], l["b"])
            pooled.append(xkv.reshape(64, 16, -1).sum(dim=1))
        out = torch.cat(pooled, dim=1)
        assert out.grad_fn is not None
        (out * wts).sum().backward()
        return [x.grad] + [l[k].grad for l in p for k in ("w", "b")]

    fwd, bwd = _count("cin_fwd"), _count("cin_bwd")
    got = grads(cin_kernel.cin_layer)
    assert _count("cin_fwd") == fwd + 3
    assert _count("cin_bwd") == bwd + 3
    ref = grads(cin_kernel.cin_layer_reference)
    for g, r in zip(got, ref):
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,v", [(229_376, 837_632), (409_600, 4096),
                                 (3333, 1000), (1, 5)])
def test_segment_sum_kernel_matches_plain_version(cuda_device, n, v):
    gen = torch.Generator().manual_seed(n)
    # zipf-like ids: hot rows with long segments, as the Criteo fields give
    u = torch.rand(n, generator=gen)
    ids = (v * u ** 2.2).long().clamp_(max=v - 1).to(cuda_device)
    g = torch.randn(n, 17, generator=gen).to(cuda_device)
    before = _count("segment_sum")
    got = ss.segment_sum(ids, g, v)
    torch.cuda.synchronize()
    assert _count("segment_sum") == before + 1
    torch.testing.assert_close(got, ss.segment_sum_reference(ids, g, v),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, ss.segment_sum(ids, g, v))   # bitwise


def test_segment_sum_kernel_edge_cases(cuda_device):
    g = torch.randn(5000, 17, device=cuda_device)
    one = torch.full((5000,), 7, dtype=torch.int64, device=cuda_device)
    got = ss.segment_sum(one, g, 10)
    torch.testing.assert_close(got, ss.segment_sum_reference(one, g, 10),
                               rtol=1e-5, atol=1e-3)
    assert not got[torch.arange(10, device=cuda_device) != 7].any()
    before = _count("segment_sum")
    empty = ss.segment_sum(one[:0], g[:0], 10)
    assert empty.shape == (10, 17) and not empty.any()
    assert _count("segment_sum") == before    # N = 0 launches no kernel
    wide = torch.randn(300, 70, device=cuda_device)     # W > 32
    ids = torch.randint(0, 40, (300,), device=cuda_device)
    torch.testing.assert_close(ss.segment_sum(ids, wide, 40),
                               ss.segment_sum_reference(ids, wide, 40),
                               rtol=1e-5, atol=1e-4)


def _zipf_ids(n, v, gen):
    """Zipf-like ids in [0, v) with v - 1 among them: hot rows whose
    segments cross many chunks of 128, as the Criteo fields give."""
    ids = (v * torch.rand(n, generator=gen) ** 2.2).long().clamp_(max=v - 1)
    ids[: min(n, 3)] = v - 1
    return ids


@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 16, 17, 32, 33, 70])
@pytest.mark.parametrize("n", [1, 127, 5000, 70_001])
def test_segment_sum_kernel_at_every_width(cuda_device, w, n):
    """Every warp layout (32, 16, 8, 4 or 2 entries a step below W = 17,
    one entry and column tiles of 32 from it), N not a multiple of the
    chunk, into a power-of-two table whose last row is hit: within the
    plain version's tolerance (sums in another order) and bitwise equal
    from call to call."""
    gen = torch.Generator().manual_seed(w * 1000 + n)
    v = 4096
    ids = _zipf_ids(n, v, gen).to(cuda_device)
    g = torch.randn(n, w, generator=gen).to(cuda_device)
    got = ss.segment_sum(ids, g, v)
    torch.testing.assert_close(got, ss.segment_sum_reference(ids, g, v),
                               rtol=1e-5, atol=1e-4)
    assert got[v - 1].abs().sum() > 0
    assert torch.equal(got, ss.segment_sum(ids, g, v))   # bitwise


@pytest.mark.parametrize("w", [1, 17])
def test_segment_sum_kernel_drops_ids_out_of_range(cuda_device, w):
    """Negative ids and ids at or past ``num_rows`` add nothing; every
    other id sums as it would without them. All-equal ids make one
    segment across every chunk."""
    gen = torch.Generator().manual_seed(w)
    n, v = 20_000, 1000
    ids = torch.randint(-50, v + 50, (n,), generator=gen)
    ids[::7] = 2 ** 40
    ids[::11] = -(2 ** 40)
    g = torch.randn(n, w, generator=gen)
    keep = (ids >= 0) & (ids < v)
    got = ss.segment_sum(ids.to(cuda_device), g.to(cuda_device), v)
    ref = ss.segment_sum_reference(ids[keep], g[keep], v)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-4)
    same = torch.full((n,), v - 1, dtype=torch.int64, device=cuda_device)
    gd = g.to(cuda_device)
    got = ss.segment_sum(same, gd, v)
    torch.testing.assert_close(got, ss.segment_sum_reference(same, gd, v),
                               rtol=1e-5, atol=1e-3)
    assert torch.equal(got, ss.segment_sum(same, gd, v))


def test_segment_sum_kernel_replays_in_a_cuda_graph(cuda_device):
    """The whole call (its two allocations, the memset, the sort and the
    two kernels) is captured in a CUDA graph; replays on new gradients give
    what eager calls give, bitwise."""
    gen = torch.Generator().manual_seed(3)
    ids = _zipf_ids(40_000, 30_000, gen).to(cuda_device)
    g = torch.randn(40_000, 17, generator=gen).to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.segment_sum(ids, g, 30_000)        # warm-up: build, workspace size
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.segment_sum(ids, g, 30_000)
    for seed in (4, 5):
        g.copy_(torch.randn(40_000, 17,
                            generator=torch.Generator().manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ss.segment_sum(ids, g, 30_000))


def test_segment_sum_wrapper_makes_one_call(cuda_device, monkeypatch):
    """On the card the wrapper's only torch ops are the output's and the
    workspace's ``empty``, and it calls the C side once (its workspace size
    is cached per shape)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    ids = torch.randint(0, 500, (3000,), device=cuda_device)
    g = torch.randn(3000, 8, device=cuda_device)
    ss.segment_sum(ids, g, 500)                # caches the workspace size
    lib, calls = cuda_build.load(ss.SOURCE), []

    class Counted:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(cuda_build, "load", lambda src: Counted())
    with Ops() as ops:
        ss.segment_sum(ids, g, 500)
    assert calls == ["segment_sum"]
    assert ops.seen == ["aten.empty.memory_format"] * 2


@pytest.mark.parametrize("name", ["deepfm", "xdeepfm"])
def test_three_train_steps_on_the_card_match_the_cpu(cuda_device, name):
    """3 optimizer steps from one state on one [3, B] index matrix, at
    dropout 0, on the card (kernels) and on the CPU (plain versions).
    Tolerance 1e-4 on the parameters: a tenth of one Adam step (lr 1e-3)."""
    ccfg = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    mcfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(32, 32),
                       cin_layers=(20, 10, 10), dropout=0.0)
    model = make_model(name, ccfg, mcfg)
    data = synthetic_criteo(4096, ccfg)
    idx = np.random.default_rng(0).integers(0, 4096, (3, 512))
    out = {}
    with cuda_build.counting() as n:
        for dev in ("cpu", cuda_device):
            ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
            ts, loss = fast.make_scanned_train_step(model, tx)(
                ts, fast.stage_dataset(data, dev), idx)
            out[str(dev)] = (float(loss), ts.params)
    assert n["segment_sum"] == 6
    assert n["cin_bwd"] == (9 if name == "xdeepfm" else 0)
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(tree_util.leaves(p_cpu), tree_util.leaves(p_gpu)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("v,w,n", [
    (63_002, 32, 33_792),     # DIN's item table at B=1024, P=32 (+ targets)
    (802, 32, 33_792),        # DIN's category table
    (837_632, 17, 229_376),   # the Criteo big table at B=16384
    (4_096, 17, 409_600),     # the Criteo small table at B=16384
    (1_000, 17, 3_333),       # ragged N
    (300, 1, 1_000),          # W = 1
    (64, 32, 0),              # N = 0
])
def test_row_gather_kernel_is_index_select(cuda_device, v, w, n):
    gen = torch.Generator().manual_seed(v + n)
    table = torch.randn(v, w, generator=gen).to(cuda_device)
    ids = torch.randint(0, v, (n,), generator=gen)
    if n >= 2:
        ids[:2] = torch.tensor([0, v - 1])
    ids = ids.to(cuda_device)
    before = _count("row_gather")
    got = rg.row_gather(table, ids)
    torch.cuda.synchronize()
    assert _count("row_gather") == before + (1 if n else 0)
    assert got.shape == (n, w)
    assert torch.equal(got, torch.index_select(table, 0, ids))   # bitwise


def test_row_gather_kernel_out_of_range_ids_and_alignment(cuda_device):
    """An id outside [0, V) reads nothing and gives a zero row; a table
    that is not 16-byte aligned (W % 4 == 0) takes the scalar path."""
    table = torch.randn(10, 32, device=cuda_device)
    ids = torch.tensor([-1, 10, 3, 2 ** 40, 9], device=cuda_device)
    got = rg.row_gather(table, ids)
    torch.cuda.synchronize()
    assert not got[[0, 1, 3]].any()
    assert torch.equal(got[2], table[3]) and torch.equal(got[4], table[9])
    flat = torch.randn(1 + 1000 * 32, device=cuda_device)
    shifted = flat[1:].view(1000, 32)            # 4 bytes off alignment
    ids = torch.randint(0, 1000, (5000,), device=cuda_device)
    assert torch.equal(rg.row_gather(shifted, ids), shifted[ids])


def test_din_servable_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """Five row gathers a request: the item and category tables for the
    target and the history, and the item bias."""
    mcfg = ModelConfig(name="din", embedding_dim=32, use_bn=False)
    params, state = make_model("din", 5000, 100, mcfg).init(
        torch.Generator().manual_seed(0), "cpu")
    export_servable(str(tmp_path), "din", params, state, mcfg,
                    factory_kwargs={"item_vocab": 5000, "cate_vocab": 100})
    sv = Servable(str(tmp_path), device="cuda")
    feats = sv._sample_features(300)
    with cuda_build.counting() as n:
        got = sv.predict(feats)
    assert (n["row_gather"], n["segment_sum"]) == (5, 0)
    ref = Servable(str(tmp_path), device="cpu").predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_three_din_steps_on_the_card_match_the_cpu(cuda_device):
    """3 optimizer steps of DIN at full width (attention 80-40, MLP
    100-50-20, D = 32) over 2,000 items and 40 categories, batch 256,
    history padded to 32, at dropout 0, on the card (kernels) and on the
    CPU (plain versions). Tolerance 1e-4 on the parameters."""
    ds = amazon.synthetic_din_hard(n_users=2000, item_vocab=2000,
                                   cate_vocab=40)
    model = make_model("din", 2000, 40, ModelConfig(
        name="din", embedding_dim=32, use_bn=False, dropout=0.0))
    batches = list(amazon.batches(ds, 256, seed=1, num_epochs=1))[:3]
    out = {}
    with cuda_build.counting() as n:
        for dev in ("cpu", cuda_device):
            ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
            step = TS.make_train_step(model, tx)
            for b in batches:
                ts, loss = step(ts, fast.stage_dataset(b, dev))
            out[str(dev)] = (float(loss), ts.params)
    assert n["segment_sum"] == 15          # 5 table reads per step
    assert n["row_gather"] == 15
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(tree_util.leaves(p_cpu), tree_util.leaves(p_gpu)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,engine,reads,lr", [
    ("dcn", "split", 2, 1e-3), ("deepfm", "fused", 1, 1e-3),
    ("dnn", "fused", 1, 1e-3), ("fm", "split", 2, 1e-3),
    ("wide", "split", 1, 4.0)])
def test_zoo_steps_on_the_card_match_the_cpu(cuda_device, name, engine,
                                             reads, lr):
    """3 steps of each zoo model from one state on one [3, B] index matrix
    at dropout 0, on the card and on the CPU: each step reads its tables
    through ``reads`` row gathers and differentiates them through as many
    segment sums (2 on the split engine, 1 on the fused one and for wide,
    whose FTRL update runs at alpha 4). Tolerance 1e-4 on the parameters."""
    ccfg = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    mcfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(32, 32),
                       dropout=0.0, emb_engine=engine)
    model = make_model(name, ccfg, mcfg)
    data = synthetic_criteo(4096, ccfg)
    idx = np.random.default_rng(0).integers(0, 4096, (3, 512))
    out = {}
    with cuda_build.counting() as n:
        for dev in ("cpu", cuda_device):
            ts, tx = TS.create_train_state(model, 0, lr, dev)
            ts, loss = fast.make_scanned_train_step(model, tx)(
                ts, fast.stage_dataset(data, dev), idx)
            out[str(dev)] = (float(loss), ts.params)
    assert (n["row_gather"], n["segment_sum"]) == (3 * reads, 3 * reads)
    (l_cpu, p_cpu), (l_gpu, p_gpu) = out["cpu"], out["cuda"]
    assert abs(l_cpu - l_gpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(tree_util.leaves(p_cpu), tree_util.leaves(p_gpu)):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4)


def test_servable_defaults_to_the_card(cuda_device, tmp_path):
    """``Servable(export_dir)`` with no device argument runs on the card:
    a DCN request reads its two tables through the row gather."""
    ccfg = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    mcfg = ModelConfig(name="dcn", embedding_dim=8, deep_layers=(32, 32))
    params, state = make_model("dcn", ccfg, mcfg).init(
        torch.Generator().manual_seed(0), "cpu")
    export_servable(str(tmp_path), "dcn", params, state, mcfg, ccfg)
    sv = Servable(str(tmp_path))
    assert sv.device.type == "cuda"
    d = synthetic_criteo(300, ccfg)
    feats = {"ids": d["ids"], "dense": d["dense"]}
    with cuda_build.counting() as n:
        got = sv.predict(feats)
    assert (n["row_gather"], n["segment_sum"]) == (2, 0)
    ref = Servable(str(tmp_path), device="cpu").predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


#: floats of one block's tile on the float4 path of csrc/reshape_probe.cu
#: (128 threads, U = 2 float4s a thread)
PROBE_TILE = 4 * 128 * 2
PROBE_CASES = [                                 # (VP, W, floats off)
    (837_632, 17, 0), (1001, 17, 0), (3, 1, 0),
    # n % 4 = 1, 2, 3 on an aligned base: the tail of single floats
    (3 * PROBE_TILE + 1, 1, 0), (3 * PROBE_TILE + 2, 1, 0),
    (3 * PROBE_TILE + 3, 1, 0),
    # one tile, one float4 either side of it, not a multiple of it
    (PROBE_TILE, 1, 0), (PROBE_TILE - 4, 1, 0), (PROBE_TILE + 4, 1, 0),
    (5 * PROBE_TILE + 4, 1, 0),
    # 4, 8 and 12 bytes off 16-byte alignment: the scalar path
    (1001, 17, 1), (1001, 17, 2), (1001, 17, 3),
    # below a warp
    (29, 1, 0)]


@pytest.mark.parametrize("vp,w,shift", PROBE_CASES)
def test_reshape_probes_equal_their_plain_version(cuda_device, vp, w, shift):
    gen = torch.Generator().manual_seed(vp)
    flat = torch.randn(vp * w + shift, generator=gen).to(cuda_device)[shift:]
    before = (_count("via_reshape"), _count("via_2d"))
    got_flat = rp.via_reshape(flat, w)
    got_2d = rp.via_2d(flat.view(vp, w))
    torch.cuda.synchronize()
    assert (_count("via_reshape") - before[0],
            _count("via_2d") - before[1]) == (1, 1)
    want = rp.reshape_probe_reference(flat, w)
    assert torch.equal(got_flat, want) and torch.equal(got_2d, want)
    # 4 bytes off 16-byte alignment: the scalar path
    shifted = flat[1:1 + (vp - 1) * w]
    assert torch.equal(rp.via_reshape(shifted, w),
                       rp.reshape_probe_reference(shifted, w))


def test_reshape_probe_launches_under_a_replayed_graph(cuda_device):
    """S2 and S3 captured in a `step_graph.StepGraph`: the capture's
    launches are taken back and every replay counts one of each, beside
    the warm-up's; the replayed outputs are the plain version's."""
    from recsys_tpu_torch.train import step_graph

    flat = torch.randn(1001 * 17, device=cuda_device)
    out = {}

    def step():
        out["flat"] = rp.via_reshape(flat, 17)
        out["2d"] = rp.via_2d(flat.view(1001, 17))

    graph = step_graph.StepGraph("reshape probes")
    with cuda_build.counting() as n:
        graph.capture((flat,), [flat], step)
        for _ in range(5):
            graph.replay()
        torch.cuda.synchronize()
    assert (n["via_reshape"], n["via_2d"]) == (1 + 5, 1 + 5)
    want = rp.reshape_probe_reference(flat, 17)
    assert torch.equal(out["flat"], want) and torch.equal(out["2d"], want)


# ---------------------------------------------------------------------------
# the K-step calls as CUDA-graph replays (train/step_graph.py)
# ---------------------------------------------------------------------------

GRAPH_VOCABS = (50,) * 20 + (3000,) * 6
# (model, engine, table reads a step, lr): the zoo and xDeepFM
GRAPH_CASES = [("deepfm", "split", 2, 1e-3), ("deepfm", "fused", 1, 1e-3),
               ("dcn", "split", 2, 1e-3), ("fm", "split", 2, 1e-3),
               ("dnn", "fused", 1, 1e-3), ("wide", "split", 1, 4.0),
               ("xdeepfm", "split", 2, 1e-3)]


def _graph_model(name, engine, dropout=0.5):
    ccfg = CriteoConfig(cat_vocabs=GRAPH_VOCABS)
    mcfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(32, 32),
                       cin_layers=(20, 10, 10), dropout=dropout,
                       emb_engine=engine)
    return make_model(name, ccfg, mcfg), ccfg


def _leaves(ts):
    return tree_util.leaves((ts.params, ts.model_state, ts.opt_state))


def _assert_bitwise(ts_a, ts_b):
    for a, b in zip(_leaves(ts_a), _leaves(ts_b), strict=True):
        assert torch.equal(a, b), float((a - b).abs().max())


def _count(name: str) -> int:
    """Launches counted so far under ``name`` (`cuda_build.launches`)."""
    return cuda_build.launches()[name]


def _kernel_counts():
    n = cuda_build.launches()
    return np.array([n["segment_sum"], n["row_gather"], n["cin_fwd"],
                     n["cin_bwd"]])


@pytest.mark.parametrize("name,engine,reads,lr", GRAPH_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in GRAPH_CASES])
def test_graphed_calls_equal_eager_calls_bitwise(cuda_device, name, engine,
                                                 reads, lr):
    """Two devgen calls of K = 5 at dropout 0.5 from equal states, graphed
    and eager: every parameter, BN stat and optimizer leaf and the mean
    loss bitwise equal (every kernel on the path is bitwise repeatable and
    each replay draws what the eager step draws); then the eval call,
    graphed and eager, gives bitwise the same metric state."""
    from recsys_tpu_torch.train import metrics as M

    model, ccfg = _graph_model(name, engine)
    data = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    out = {}
    for graphed in (False, True):
        ts, tx = TS.create_train_state(model, 0, lr, cuda_device)
        steps = fast.make_scanned_train_step_devgen(model, tx, 4096, 512,
                                                    graphed=graphed)
        losses = []
        for c in range(2):
            ts, loss = steps(ts, data, 5, 5 * c)
            losses.append(loss)
        idx = np.arange(3 * 512).reshape(3, 512)
        metrics = fast.make_scanned_eval(model, graphed=graphed)(
            ts.params, ts.model_state, data, idx,
            M.init_binary_metrics(device=cuda_device))
        out[graphed] = (ts, losses, metrics)
    (ts_e, l_e, m_e), (ts_g, l_g, m_g) = out[False], out[True]
    assert int(ts_e.step) == int(ts_g.step) == 10
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g))
    _assert_bitwise(ts_e, ts_g)
    assert all(torch.equal(a, b) for a, b in zip(m_e, m_g))
    assert float(m_g.count) == 3 * 512


@pytest.mark.parametrize("name,engine,reads", [
    ("deepfm", "split", 2), ("wide", "split", 1), ("xdeepfm", "split", 2)])
def test_graphed_launch_counts_are_reads_times_steps(cuda_device, name,
                                                     engine, reads):
    """Under replay the wrappers' counters count launches that ran: the
    capture's own counts are taken back and every replay adds them."""
    model, ccfg = _graph_model(name, engine)
    data = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    ts, tx = TS.create_train_state(model, 0, 1e-3, cuda_device)
    steps = fast.make_scanned_train_step_devgen(model, tx, 4096, 512)
    cin = 3 if name == "xdeepfm" else 0
    for c, k in enumerate((1, 7, 4)):     # capture in a call of one step
        before = _kernel_counts()
        ts, _ = steps(ts, data, k, c * 7)
        torch.cuda.synchronize()
        assert list(_kernel_counts() - before) == [reads * k, reads * k,
                                                   cin * k, cin * k]


def _device_kernels(prof) -> list:
    """The names of a profile's device operations, in start order."""
    from torch.autograd import DeviceType

    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA]


def test_the_step_marks_build_and_launch(cuda_device):
    """``csrc/step_marks.cu`` builds and loads. Outside a capture a mark
    launches nothing; captured, the five marks are nodes of the graph, run
    in order by every replay; an unknown mark number is refused."""
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.ops import cuda_build
    from recsys_tpu_torch.utils import profiling

    x = torch.zeros(1, device=cuda_device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name in profiling.MARKS:
            profiling.mark(name, x)
        torch.cuda.synchronize()
    assert not [n for n in _device_kernels(prof) if "recsys_mark" in n]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(cuda_device)):
        for name in profiling.MARKS:
            profiling.mark(name, x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
    assert _device_kernels(prof) == [f"recsys_mark_{m}"
                                     for m in profiling.MARKS] * 2
    lib = cuda_build.load(profiling.MARK_SOURCE)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    with pytest.raises(RuntimeError, match="invalid argument"):
        cuda_build.check(lib, lib.recsys_mark(len(profiling.MARKS), stream),
                         "recsys_mark")


def test_a_mark_on_a_card_other_than_the_current_one(cuda_device):
    """Marks on a tensor of the second card while the first is current:
    eagerly they launch nothing; captured on a stream of the second card,
    they replay there, and the first card stays current."""
    from recsys_tpu_torch.utils import profiling

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    other = torch.device("cuda", 1)
    x = torch.zeros(1, device=other)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(0):
        for name in profiling.MARKS:
            profiling.mark(name, x)
        with torch.cuda.graph(graph, stream=torch.cuda.Stream(other)):
            for name in profiling.MARKS:
                profiling.mark(name, x)
        graph.replay()
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other)


def test_graphed_devgen_call_marks_each_replay(cuda_device):
    """Two graphed devgen calls of K = 4 under ``torch.profiler`` (the
    first captures: its step 0 is the eager warm-up, the rest replays):
    the card runs the five marks in order once a replay (the warm-up
    launches none), and the spans stay on the host's track, none on the
    card's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recsys_tpu_torch.utils import profiling

    model, ccfg = _graph_model("deepfm", "split")
    data = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    ts, tx = TS.create_train_state(model, 0, 1e-3, cuda_device)
    steps = fast.make_scanned_train_step_devgen(model, tx, 4096, 512)
    profiling.mark("begin", data["label"])      # the build and load
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in range(2):
            ts, _ = steps(ts, data, 4, 4 * c)
        torch.cuda.synchronize()
    events = prof.events()
    device = sorted((e.time_range.start, e.name) for e in events
                    if e.device_type == DeviceType.CUDA)
    marks = [name for _, name in device if name.startswith("recsys_mark_")]
    assert marks == [f"recsys_mark_{m}" for m in profiling.MARKS] * 7
    assert not [name for _, name in device if name.startswith("recsys.")]
    host = collections.Counter(e.name for e in events
                               if e.name.startswith("recsys."))
    assert host == {"recsys.train.call": 2, "recsys.train.host_step": 8}


def test_graphed_resume_continues_the_run_bitwise(cuda_device, tmp_path):
    """12 steps of DeepFM at dropout 0.5 on the card through the graphed
    fast loop, and 6 steps, a resume from their checkpoint and 6 more, in
    calls of K = 4 (so the resume lands inside a call's span): bitwise the
    same parameters, BN stats and optimizer state."""
    from recsys_tpu_torch.core.config import TrainConfig
    from recsys_tpu_torch.train import loop

    model, ccfg = _graph_model("deepfm", "split")
    data = synthetic_criteo(4096, ccfg)
    evald = synthetic_criteo(1024, ccfg, start_row=10 ** 6)

    def run(model_dir, num_steps):
        cfg = TrainConfig(batch_size=256, learning_rate=1e-2,
                          eval_every_steps=6, eval_steps=2, seed=5,
                          model_dir=str(model_dir))
        loop.train_and_evaluate_fast(model, data, evald, cfg,
                                     num_steps=num_steps, device=cuda_device,
                                     steps_per_call=4)
        with np.load(model_dir / f"step_{num_steps}" / "arrays.npz") as z:
            return {k: z[k] for k in z.files}

    whole = run(tmp_path / "whole", 12)
    run(tmp_path / "split", 6)
    split = run(tmp_path / "split", 12)
    assert whole.keys() == split.keys()
    for k in whole:
        np.testing.assert_array_equal(split[k], whole[k], err_msg=k)


def test_sampler_step_graphed_equals_eager_and_resumes(cuda_device):
    """The convergence protocol's K-step call on the card: the sampler's
    draws and dropout's inside one captured step; 3 + 4 graphed steps in
    two calls bitwise equal to 7 eager steps in one (a cosine schedule
    whose warm-up ends inside), with 2 row gathers and 2 segment sums a
    step under replay."""
    from recsys_tpu_torch.data import synthetic_device as sd
    from recsys_tpu_torch.train import optim

    model, ccfg = _graph_model("deepfm", "split")
    tables = sd.device_tables(sd.planted_tables(ccfg), cuda_device)
    sample = sd.make_device_sampler(ccfg)
    out = {}
    for graphed, calls in ((False, (7,)), (True, (3, 4))):
        ts, tx = TS.create_train_state(
            model, 0, 1e-2, cuda_device,
            opt=optim.adam(optim.cosine_decay(1e-2, 7, warmup_steps=3)))
        steps = fast.make_scanned_train_step_sampler(model, tx, sample, 512,
                                                     graphed=graphed)
        done, before = 0, _kernel_counts()
        for k in calls:
            ts, loss = steps(ts, tables, k, done)
            done += k
        torch.cuda.synchronize()
        out[graphed] = (ts, _kernel_counts() - before)
    _assert_bitwise(out[False][0], out[True][0])
    assert list(out[True][1]) == [14, 14, 0, 0]


def test_cosine_decay_on_the_card_is_the_cpus():
    """The schedule a captured step reads: on the card within 2e-7 of
    the CPU's (relative, and of the peak near 0), on the device of its
    step tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from recsys_tpu_torch.train import optim

    lr = optim.cosine_decay(6e-3, 100, warmup_steps=10)
    t = torch.arange(111, dtype=torch.float32)
    got = lr(t.cuda())
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), lr(t), rtol=2e-7, atol=2e-7 * 6e-3)


def test_graph_recaptures_for_a_new_state_or_dataset(cuda_device):
    """One graphed step function called with a new train state, then with
    another staged dataset: each call recaptures and gives what an eager
    call gives on the same inputs, and never writes into the storage of
    the state or data it was captured on before."""
    model, ccfg = _graph_model("deepfm", "split")
    data1 = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    data2 = fast.stage_dataset(synthetic_criteo(4096, ccfg, start_row=7777),
                               cuda_device)

    def fresh(seed):
        return TS.create_train_state(model, seed, 1e-3, cuda_device)

    ts1, tx = fresh(0)
    graphed = fast.make_scanned_train_step_devgen(model, tx, 4096, 512)
    eager = fast.make_scanned_train_step_devgen(model, tx, 4096, 512,
                                                graphed=False)
    ts1, _ = graphed(ts1, data1, 3, 0)
    snap1 = [t.clone() for t in _leaves(ts1)]

    ts2, _ = fresh(1)          # another state, the same optimizer
    ts2, _ = graphed(ts2, data1, 3, 0)
    ref2, _ = fresh(1)
    ref2, _ = eager(ref2, data1, 3, 0)
    _assert_bitwise(ts2, ref2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(ts1), snap1))

    ts1, _ = graphed(ts1, data2, 3, 3)        # the first state, new data
    ref1, _ = fresh(0)
    ref1, _ = eager(ref1, data1, 3, 0)
    ref1, _ = eager(ref1, data2, 3, 3)
    _assert_bitwise(ts1, ref1)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(ts2),
                                                 _leaves(ref2)))


def test_a_failed_capture_raises_and_runs_nothing_eagerly(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    call raises with the step function's name, and the steps after the
    warm-up do not run eagerly in its place."""
    import dataclasses

    model, ccfg = _graph_model("fm", "split")

    def apply(*args, **kwargs):
        logits, state = model.apply(*args, **kwargs)
        float(logits.sum())       # a host read: refused inside a capture
        return logits, state

    bad = dataclasses.replace(model, apply=apply)
    data = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    ts, tx = TS.create_train_state(bad, 0, 1e-3, cuda_device)
    steps = fast.make_scanned_train_step_devgen(bad, tx, 4096, 512)
    before = _kernel_counts()
    with pytest.raises(RuntimeError,
                       match="make_scanned_train_step_devgen: CUDA graph "
                             "capture failed"):
        steps(ts, data, 5, 0)
    torch.cuda.synchronize()
    assert list(_kernel_counts() - before) == [2, 2, 0, 0]   # the warm-up
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    assert float(torch.ones(3, device=cuda_device).sum()) == 3.0


# ------------------------------------------------------ the host-fed pipeline

def _din_batches_on(device, ps, b=256):
    """DIN batches (full vocabs) with histories cut or zero-padded to each
    P of ``ps``, staged on ``device``."""
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB

    ds = amazon.synthetic_din_hard(n_users=2000, item_vocab=ITEM_VOCAB,
                                   cate_vocab=CATE_VOCAB)
    out = []
    for i, p in enumerate(ps):
        rows = slice(i * b, (i + 1) * b)
        batch = {"i_id": ds.i_id[rows], "i_cate": ds.i_cate[rows],
                 "label": ds.label[rows]}
        for k in ("hist_iid", "hist_cate"):
            h = np.zeros((b, p), np.int32)
            w = min(p, getattr(ds, k).shape[1])
            h[:, :w] = getattr(ds, k)[rows, :w]
            batch[k] = h
        out.append(fast.stage_dataset(batch, device))
    return out


def _din_model_on_card(dropout=0.1):
    from recsys_tpu_torch.models.din import CATE_VOCAB, ITEM_VOCAB

    return make_model("din", ITEM_VOCAB, CATE_VOCAB, ModelConfig(
        name="din", embedding_dim=32, use_bn=False, dropout=dropout))


def _fed_steps(model, batches, device, graphed):
    ts, tx = TS.create_train_state(model, 0, 1e-3, device)
    step = fast.make_fed_train_step(model, tx, graphed=graphed)
    losses = [step(ts, batch, 3 + i) for i, batch in enumerate(batches)]
    return ts, losses


@pytest.mark.parametrize("name", ["deepfm", "din"])
def test_fed_step_graphed_equals_eager_bitwise(cuda_device, name,
                                               monkeypatch):
    """The host-fed step replaying its graph against the same step run
    eagerly, 6 batches at dropout 0.5 (DIN 0.1) from equal states: every
    leaf and every loss bitwise equal; one capture for one batch layout,
    and the launch counts those of the steps that ran."""
    from recsys_tpu_torch.train import step_graph

    if name == "deepfm":
        model, ccfg = _graph_model("deepfm", "split")
        batches = [fast.stage_dataset(synthetic_criteo(
            512, ccfg, start_row=600 * i), cuda_device) for i in range(6)]
        per_step = [2, 2, 0, 0]
    else:
        model = _din_model_on_card()
        batches = _din_batches_on(cuda_device, [32] * 6)
        per_step = [5, 5, 0, 0]
    captures = []
    real = step_graph.StepGraph.capture
    monkeypatch.setattr(step_graph.StepGraph, "capture",
                        lambda self, *a, **k: (captures.append(self.name),
                                               real(self, *a, **k))[1])
    ts_e, l_e = _fed_steps(model, batches, cuda_device, graphed=False)
    before = _kernel_counts()
    ts_g, l_g = _fed_steps(model, batches, cuda_device, graphed=True)
    torch.cuda.synchronize()
    assert list(_kernel_counts() - before) == [6 * n for n in per_step]
    assert captures == ["make_fed_train_step"]
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    _assert_bitwise(ts_e, ts_g)


def test_fed_step_recaptures_at_a_new_history_length(cuda_device,
                                                     monkeypatch):
    """DIN at P = 16, then 32, then 16 again: each new layout captures
    anew (never replays into buffers of another shape), bitwise the eager
    steps."""
    from recsys_tpu_torch.train import step_graph

    captures = []
    real = step_graph.StepGraph.capture
    monkeypatch.setattr(step_graph.StepGraph, "capture",
                        lambda self, *a, **k: (captures.append(self.name),
                                               real(self, *a, **k))[1])
    model = _din_model_on_card()
    batches = _din_batches_on(cuda_device, [16, 16, 32, 32, 16])
    ts_e, l_e = _fed_steps(model, batches, cuda_device, graphed=False)
    ts_g, l_g = _fed_steps(model, batches, cuda_device, graphed=True)
    assert captures == ["make_fed_train_step"] * 3
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    _assert_bitwise(ts_e, ts_g)


def test_device_prefetch_on_the_card_gives_the_host_arrays(cuda_device):
    from recsys_tpu_torch.data.loader import device_prefetch

    rng = np.random.default_rng(0)
    host = [{"ids": rng.integers(0, 1 << 30, (4096, 39)).astype(np.int32),
             "dense": rng.random((4096, 13)).astype(np.float32),
             "mask": rng.random(4096) < 0.5} for _ in range(7)]
    got = []
    for batch in device_prefetch(iter(host), cuda_device):
        assert batch["ids"].device.type == "cuda"
        # the consumer's stream has waited on the copy: read it there
        got.append({k: v.clone() for k, v in batch.items()})
    assert len(got) == len(host)
    for g, h in zip(got, host):
        assert g["ids"].dtype == torch.int64
        assert g["dense"].dtype == torch.float32
        assert g["mask"].dtype == torch.bool
        for k in h:
            np.testing.assert_array_equal(g[k].cpu().numpy(), h[k],
                                          err_msg=k)


def test_pinned_slots_are_reused_only_after_their_copy(cuda_device,
                                                       monkeypatch):
    """A ring of 2 pinned slots and 3 batches of 64 MB: the third batch
    writes slot 0 again only after waiting on the event behind slot 0's
    copy, reuses slot 0's pinned buffer, and the first batch's device copy
    still holds the first batch."""
    from recsys_tpu_torch.data import loader

    waited = []

    class Event(torch.cuda.Event):
        def synchronize(self):
            waited.append(self)
            super().synchronize()

    monkeypatch.setattr(torch.cuda, "Event", Event)
    stager = loader._CudaStager(cuda_device,
                                torch.cuda.current_stream(cuda_device), 2)
    host = [{"x": np.full(16 << 20, i, np.float32)} for i in range(3)]
    out = [stager(h) for h in host[:2]]
    pinned0 = stager.ring[0]["x"]
    assert pinned0.is_pinned() and not waited
    out.append(stager(host[2]))
    assert waited == [out[0][1]]                 # slot 0's own event
    assert stager.ring[0]["x"] is pinned0        # the buffer was reused
    for (dev, event), h in zip(out, host):
        torch.cuda.current_stream().wait_event(event)
        assert torch.equal(dev["x"].cpu(), torch.from_numpy(h["x"]))


def test_device_prefetch_raises_a_transfer_error_on_the_card(cuda_device):
    from recsys_tpu_torch.data.loader import device_prefetch

    def source():
        yield {"x": np.zeros(4, np.float32)}
        yield {"x": np.array([object()])}          # torch cannot take it
        yield {"x": np.zeros(4, np.float32)}

    it = device_prefetch(source(), cuda_device)
    assert next(it)["x"].device.type == "cuda"
    with pytest.raises(TypeError):
        next(it)


def test_fed_step_captures_while_a_stager_copies(cuda_device):
    """Four captures of the fed step (DeepFM, a new batch width for each,
    so each empties the allocator's cache and captures anew) while a
    second thread stages batches of changing shapes through a 2-slot
    pinned ring, as `device_prefetch`'s transfer thread does: fresh pinned
    slots, device allocations (real ones: the cache was emptied, and the
    blocks the stager frees wait for the capture's end) and waits on a
    slot's event fall inside the captures. Neither thread's calls fail,
    and the graphed steps equal the eager ones bitwise."""
    from recsys_tpu_torch.data import loader

    stop = threading.Event()
    errors, staged = [], [0]
    # as device_prefetch does: the thread sets the device by its index
    device = torch.device("cuda", torch.cuda.current_device())

    def stage():
        try:
            torch.cuda.set_device(device)
            stager = loader._CudaStager(device,
                                        torch.cuda.current_stream(device), 2)
            k = 0
            while not stop.is_set():
                n = 1024 * (1 + k % 17)        # a new shape every batch
                stager({"ids": np.full((n, 39), k, np.int32),
                        "dense": np.ones((n, 13), np.float32)})
                k += 1
                staged[0] = k
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    model, ccfg = _graph_model("deepfm", "split")
    widths = [512, 512, 448, 448, 384, 384, 320, 320]
    batches = [fast.stage_dataset(synthetic_criteo(b, ccfg, start_row=600 * i),
                                  cuda_device) for i, b in enumerate(widths)]
    ts_e, l_e = _fed_steps(model, batches, cuda_device, graphed=False)
    thread = threading.Thread(target=stage, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60
        while staged[0] < 4 and not errors and time.monotonic() < deadline:
            time.sleep(0.01)
        assert staged[0] >= 4, errors
        start = staged[0]
        ts_g, l_g = _fed_steps(model, batches, cuda_device, graphed=True)
        torch.cuda.synchronize()
        during = staged[0] - start
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert not errors, errors
    assert during > 0                  # the stager ran beside the captures
    assert all(torch.equal(a, b) for a, b in zip(l_e, l_g, strict=True))
    _assert_bitwise(ts_e, ts_g)


# ------------------------------------------------ serving: bucket graphs

def _serving_export(path, key):
    """A port export of a narrow model, every branch's weights seeded
    noise: xDeepFM (CIN 20-10-10), DCN on the fused engine, or DIN."""
    if key == "din":
        mcfg = ModelConfig(name="din", embedding_dim=32, use_bn=False)
        params, state = make_model("din", 5000, 100, mcfg).init(
            torch.Generator().manual_seed(0), "cpu")
        export_servable(str(path), "din", params, state, mcfg,
                        factory_kwargs={"item_vocab": 5000,
                                        "cate_vocab": 100})
        return str(path)
    name, engine = {"xdeepfm": ("xdeepfm", "split"),
                    "dcn": ("dcn", "fused")}[key]
    ccfg = CriteoConfig(cat_vocabs=GRAPH_VOCABS)
    mcfg = ModelConfig(name=name, embedding_dim=8, deep_layers=(32, 32),
                       cin_layers=(20, 10, 10), emb_engine=engine)
    params, state = make_model(name, ccfg, mcfg).init(
        torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    params = tree_util.fill_like(params, [
        p + 0.1 * torch.randn(p.shape, generator=gen)
        for p in tree_util.leaves(params)])
    export_servable(str(path), name, params, state, mcfg, ccfg)
    return str(path)


def _serving_features(sv, n, seed):
    if sv.criteo_cfg is None:
        return sv.model.meta["sample_features"](n)
    d = synthetic_criteo(n, sv.criteo_cfg, start_row=1000 * seed)
    return {"ids": d["ids"], "dense": d["dense"]}


#: kernel launches of one request: (row gathers, CIN forward layers);
#: DCN here reads its one fused table
SERVING_LAUNCHES = {"xdeepfm": (2, 3), "dcn": (1, 0), "din": (5, 0)}


@pytest.mark.parametrize("key", ["xdeepfm", "dcn", "din"])
def test_graphed_servable_equals_eager_at_every_bucket(cuda_device,
                                                       tmp_path, key):
    """`warmup` captures one graph a bucket; at each bucket (and past the
    largest) the graphed answer is bitwise the eager answer at the same
    padded shape, within 1e-4 of the CPU servable, and each request
    launches its kernels exactly once under replay."""
    d = _serving_export(tmp_path, key)
    sv = Servable(d, device="cuda")
    eager = Servable(d, device="cuda", graphed=False)
    cpu = Servable(d, device="cpu")
    assert sv.graphed and not eager.graphed
    sv.warmup()
    assert sv.captures == len(sv.buckets)
    rows, cin = SERVING_LAUNCHES[key]
    for i, n in enumerate((1, 5, 8, 64, 200, 256, 1000, 4096)):
        feats = _serving_features(sv, n, i)
        with cuda_build.counting() as launches:
            got = sv.predict(feats)
            torch.cuda.synchronize()
        assert (launches["row_gather"], launches["cin_fwd"],
                launches["segment_sum"]) == (rows, cin, 0)
        np.testing.assert_array_equal(got, eager.predict(feats))
        np.testing.assert_allclose(got, cpu.predict(feats), atol=1e-4,
                                   rtol=0)
    assert sv.captures == len(sv.buckets)
    feats = _serving_features(sv, 4097, 9)     # 8192 rows: one new capture
    np.testing.assert_array_equal(sv.predict(feats), eager.predict(feats))
    assert sv.captures == len(sv.buckets) + 1


def test_concurrent_replays_answer_their_own_rows(cuda_device, tmp_path):
    """Twelve threads, mixed batches over four buckets, through one
    graphed servable: every answer is bitwise the eager answer for its own
    request."""
    d = _serving_export(tmp_path, "xdeepfm")
    sv = Servable(d, device="cuda")
    eager = Servable(d, device="cuda", graphed=False)
    sv.warmup()
    reqs = [_serving_features(sv, 1 + (37 * i) % 1500, i) for i in range(96)]
    want = [eager.predict(r) for r in reqs]
    got, errors = {}, []
    start = threading.Barrier(12)

    def client(t):
        try:
            start.wait(60)
            for i in range(t, len(reqs), 12):
                got[i] = sv.predict(reqs[i])
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w, err_msg=f"request {i}")


def test_a_capture_beside_another_threads_launches_counts_its_own(
        cuda_device, tmp_path):
    """DIN captures new signatures (a new history length) while another
    thread copies to the card and launches row gathers eagerly: neither
    fails, the answers are the eager ones, and each graph's launch counts
    are its own request's (5 row gathers), whatever the other thread
    counted during the capture."""
    d = _serving_export(tmp_path, "din")
    sv = Servable(d, device="cuda")
    eager = Servable(d, device="cuda", graphed=False)
    stop, errors, launched = threading.Event(), [], [0]
    device = torch.device("cuda", torch.cuda.current_device())

    def other():
        try:
            torch.cuda.set_device(device)
            table = torch.randn(5000, 32, device=device)
            while not stop.is_set():
                ids = torch.from_numpy(
                    np.random.randint(0, 5000, 4096)).to(device)
                rg.row_gather(table, ids)
                launched[0] += 1
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    thread = threading.Thread(target=other, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60
        while launched[0] < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
        answers = []
        for p in (8, 16, 24, 40):
            feats = sv.model.meta["sample_features"](300, hist_len=p)
            answers.append((feats, sv.predict(feats)))
        during = launched[0]
    finally:
        stop.set()
        thread.join(30)
    assert not thread.is_alive() and not errors, errors
    assert during > 10
    assert sv.captures == 4
    for feats, got in answers:
        np.testing.assert_array_equal(got, eager.predict(feats))
        before = _count("row_gather")
        sv.predict(feats)                       # a replay
        assert _count("row_gather") - before == 5


# ---------------------------------------------------------------------------
# The sharded exchange at one member, over NCCL (the card's machine has one
# card; several members are held against the JAX package on the CPU, over
# gloo: tests/test_torch_sharded_embedding.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """(device, 1×1 mesh) of a world of one rank joined through a file
    store; the process group is destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs only on the card")
    import torch.distributed as dist

    from recsys_tpu_torch.core import mesh as mesh_lib
    from recsys_tpu_torch.core.config import MeshConfig

    store = tmp_path_factory.mktemp("nccl") / "store"
    dev = mesh_lib.distributed_init(f"file://{store}", 1, 0, timeout_s=120)
    yield dev, mesh_lib.make_mesh(MeshConfig(), dev)
    dist.destroy_process_group()


def _big_table_and_ids(dev, batch=16384):
    """DeepFM's full-width big table and the big fields' global ids of a
    synthetic batch."""
    ccfg = CriteoConfig()
    model = make_model("deepfm", ccfg, ModelConfig())
    params, _ = model.init(torch.Generator().manual_seed(0), dev)
    engine = model.meta["engine"]
    ids = torch.from_numpy(synthetic_criteo(batch, ccfg)["ids"]).to(
        dev, torch.int64)
    (_, _, fields, offsets), = [c for c in engine._index_tensors(dev)
                                if c[0] == "big"]
    return params["tables"]["big"], ids.index_select(1, fields) + offsets


def test_distributed_init_picks_nccl_and_the_card(nccl_mesh):
    import torch.distributed as dist

    dev, env = nccl_mesh
    assert dist.get_backend() == "nccl"
    assert dev.type == "cuda" and env.device == dev
    assert (env.num_data, env.num_model, env.d, env.m) == (1, 1, 0, 0)


def test_a2a_lookup_at_one_member_is_bitwise_the_table_gather(nccl_mesh):
    from recsys_tpu_torch.embeddings import table as emb_table
    from recsys_tpu_torch.parallel import sharded_embedding as SE

    dev, env = nccl_mesh
    table, gids = _big_table_and_ids(dev)
    before = _count("row_gather")
    got = SE.a2a_embedding_lookup(table, gids, env.model, exact=True)
    torch.cuda.synchronize()
    assert _count("row_gather") == before + 1     # the owner gather: S1
    assert torch.equal(got, emb_table.table_gather(table, gids))
    assert torch.equal(got, SE.psum_embedding_lookup(table, gids, env.model))


def test_a2a_lookup_gradient_at_one_member_matches_local(nccl_mesh):
    """The table gradient through the exchange (the owner gather's
    backward: the segment-sum kernel, K2's contract) against the local
    gather's, within 1e-5 of the largest."""
    from recsys_tpu_torch.embeddings import table as emb_table
    from recsys_tpu_torch.parallel import sharded_embedding as SE

    dev, env = nccl_mesh
    table, gids = _big_table_and_ids(dev)
    g_out = torch.randn(*gids.shape, table.shape[1], device=dev,
                        generator=torch.Generator(dev).manual_seed(3))
    grads = []
    for lookup in (lambda t: SE.a2a_embedding_lookup(t, gids, env.model,
                                                     exact=True),
                   lambda t: emb_table.table_gather(t, gids)):
        live = table.detach().clone().requires_grad_()
        before = _count("segment_sum")
        (g,) = torch.autograd.grad((lookup(live) * g_out).sum(), live)
        torch.cuda.synchronize()
        assert _count("segment_sum") == before + 1  # the kernel, no index_add_
        grads.append(g)
    err = float((grads[0] - grads[1]).abs().max())
    assert err <= 1e-5 * float(grads[1].abs().max()), err


def test_spmd_state_gathers_to_the_host_and_resumes_at_one_member(
        nccl_mesh, tmp_path, monkeypatch):
    """Full-width DeepFM's SPMD state over NCCL: gathered to rank 0's
    host in pieces of 1 MiB (`spmd_loop.whole_state`, what a checkpoint
    writes) it equals the state; written and read back by `resume_state`
    into a state from another seed, it is the state again."""
    from recsys_tpu_torch import convert
    from recsys_tpu_torch.core.checkpoint import CheckpointManager
    from recsys_tpu_torch.parallel import spmd
    from recsys_tpu_torch.train import optim, spmd_loop

    dev, env = nccl_mesh
    monkeypatch.setattr(spmd, "GATHER_PIECE_BYTES", 1 << 20)
    model = make_model("deepfm", CriteoConfig(), ModelConfig())
    tx = optim.for_model(model.meta, 1e-3)
    ts = spmd.create_spmd_state(model, env, 0, tx)
    state = (ts.params, ts.model_state, ts.opt_state)
    whole = spmd_loop.whole_state(ts, env)
    want = tree_util.leaves(convert.export_params(state))
    assert len(tree_util.leaves(whole)) == len(want)
    for got, w in zip(tree_util.leaves(whole), want):
        assert np.array_equal(got, w)
    CheckpointManager(str(tmp_path)).save(7, whole)
    other = spmd.create_spmd_state(model, env, 1, tx)
    other = spmd_loop.resume_state(other, CheckpointManager(str(tmp_path)),
                                   env)
    assert int(other.step) == 7
    for got, w in zip(tree_util.leaves((other.params, other.model_state,
                                   other.opt_state)), tree_util.leaves(state)):
        assert torch.equal(got, w)


# ---------------------------------------------------------------------------
# The CF family on the card against the CPU: no kernel of the port's own
# lies on it (dense matmuls, log_softmax, topk, elementwise passes).
# Tolerances: the loss 1e-5 relative; each gradient leaf within 1e-4 of its
# largest magnitude (float32 sums over 4,096 items and 256 users in
# cuBLAS's order); the ranking metrics on one set of scores 1e-6.
# ---------------------------------------------------------------------------

CF_ITEMS, CF_BATCH = 4096, 256


def _cf_batch(seed, n=CF_BATCH, items=CF_ITEMS):
    rng = np.random.default_rng(seed)
    return (rng.random((n, items)) < 0.01).astype(np.float32)


def _assert_grads_close(got, want, rel=1e-4):
    for g, w in zip(tree_util.leaves(got), tree_util.leaves(want)):
        err = float((g.cpu() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-7, err


@pytest.mark.parametrize("model", ["multi_dae", "multi_vae", "logistic_vae"])
def test_vae_cf_loss_and_grads_on_the_card_match_the_cpu(cuda_device, model):
    from recsys_tpu_torch.train import vae_loop

    cfg = vae_loop.VaeTrainConfig(model=model, lam=0.01)
    (init, _, loss_fn), vae = vae_loop.make_model(cfg, CF_ITEMS)
    params = init(torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_cf_batch(1))
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_util.tree_map(lambda t: t.to(dev), params)
        out[str(dev)] = vae_loop.loss_and_grads(
            loss_fn, vae, p, x.to(dev), None, 0.1, 0.5, train=False)
    (l_cpu, a_cpu, g_cpu), (l_gpu, a_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert l_gpu.device.type == "cuda"
    np.testing.assert_allclose(float(l_gpu), float(l_cpu), rtol=1e-5)
    for k in a_cpu:
        np.testing.assert_allclose(float(a_gpu[k]), float(a_cpu[k]),
                                   rtol=1e-5)
    _assert_grads_close(g_gpu, g_cpu)


def test_ranking_metrics_on_the_card_match_the_cpu(cuda_device):
    from recsys_tpu_torch.train import metrics as M

    rng = np.random.default_rng(2)
    scores = rng.standard_normal((500, 20108)).astype(np.float32)
    fold_in = rng.random(scores.shape) < 0.004
    heldout = ((rng.random(scores.shape) < 0.002) & ~fold_in)
    scores[fold_in] = -np.inf
    s, h = torch.from_numpy(scores), torch.from_numpy(
        heldout.astype(np.float32))
    for fn, k in ((M.ndcg_at_k, 100), (M.recall_at_k, 20),
                  (M.recall_at_k, 50)):
        got = fn(s.to(cuda_device), h.to(cuda_device), k=k)
        torch.testing.assert_close(got.cpu(), fn(s, h, k=k), atol=1e-6,
                                   rtol=0)


def _cf_data():
    from recsys_tpu_torch.data import movielens as ML

    u, i, r = ML.synthetic_interactions(n_users=600, n_items=300, seed=3)
    return ML.preprocess_vae_cf(u, i, r, n_heldout_users=80,
                                rating_threshold=0.0)


def test_vae_trainer_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """``multi_dae`` at keep_prob 1.0 draws nothing: the card's run and the
    CPU's agree (losses and NDCG 1e-4 relative, the same best epoch)."""
    from recsys_tpu_torch.train import summaries, vae_loop

    data = _cf_data()
    runs = {}
    for dev in ("cpu", "cuda"):
        cfg = vae_loop.VaeTrainConfig(
            model="multi_dae", keep_prob=1.0, latent_dim=32, hidden_dim=96,
            epochs=3, batch_size=128, eval_batch_size=64,
            model_dir=str(tmp_path / dev))
        runs[dev] = (vae_loop.train_vae_cf(data, cfg, device=dev),
                     summaries.read_scalars(cfg.model_dir))
    (r_cpu, s_cpu), (r_gpu, s_gpu) = runs["cpu"], runs["cuda"]
    assert r_gpu["best_epoch"] == r_cpu["best_epoch"]
    for a, b in zip(s_gpu, s_cpu):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["ndcg@100"], b["ndcg@100"], rtol=1e-4)
    np.testing.assert_allclose(r_gpu["test"]["ndcg@100"],
                               r_cpu["test"]["ndcg@100"], rtol=1e-4)


def test_vae_cli_trains_on_the_card(cuda_device, tmp_path):
    """``train_vae --device=cuda``: the VAE's dropout and ε drawn on the
    card, validation each epoch, ``best/`` restored for the test."""
    import os

    from recsys_tpu_torch.tools import train_vae

    result = train_vae.main([
        "--device=cuda", "--epochs=3", "--batch_size=100",
        "--latent_dim=16", "--hidden_dim=48", "--synthetic_users=400",
        "--synthetic_items=200", "--n_heldout_users=60",
        "--eval_batch_size=64", f"--model_dir={tmp_path}/vae"])
    assert 0 <= result["best_epoch"] < 3
    assert np.isfinite(result["test"]["ndcg@100"])
    assert result["test"]["eval_users"] > 0
    assert os.path.isdir(tmp_path / "vae" / "best")


def test_cdae_on_the_card_learns_and_ranks_as_the_cpu(cuda_device):
    from recsys_tpu_torch.data import movielens as ML
    from recsys_tpu_torch.models import cdae
    from recsys_tpu_torch.train import metrics as M

    users, train_x, _, test_x = ML.synthetic_ml100k(300, 200, seed=5)
    params, apply, losses = cdae.train_cdae(
        train_x, users, hidden=32, epochs=15, batch_size=64,
        device=cuda_device)
    assert tree_util.leaves(params)[0].device.type == "cuda"
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    pred = cdae.predict_topn(apply, params, train_x, users, 10)
    assert M.success_rate_at_n(pred, test_x) > 15.0
    on_cpu = tree_util.tree_map(lambda t: t.cpu(), params)
    cpu_pred = cdae.predict_topn(apply, on_cpu, train_x, users, 10)
    # the same top 10, up to near-ties of the float32 scores
    assert np.mean(np.sort(pred, 1) == np.sort(cpu_pred, 1)) > 0.99


def test_cavi_on_the_card_stops_at_the_cpus_sweep(cuda_device):
    """10,000 points: the ELBO (≈ 1.4e5) carries float32 sum errors of
    ~0.1, so epsilon sits in a wide gap of its differences (5.2, then
    0.98, in float64): the stop is the data's, not the rounding's."""
    from recsys_tpu_torch.extras import vi_gmm as G

    gen = torch.Generator().manual_seed(1)
    data = G.sample_gmm(gen, [-4.0, 0.0, 4.0, 9.0], 1.0, 2500, device="cpu")
    state = G.init_state(gen, data, 4)
    cpu = G.fit_from(data, state, epsilon=2.0, max_iters=500)
    gpu = G.fit_from(data.to(cuda_device),
                     G.GmmState(*(t.to(cuda_device) for t in state)),
                     epsilon=2.0, max_iters=500)
    assert gpu.m.device.type == "cuda"
    assert int(gpu.it) == int(cpu.it) < 500
    torch.testing.assert_close(gpu.m.cpu(), cpu.m, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Adam's update (ops/adam_update.py, csrc/adam_update.cu): bitwise the plain
# loop, whose operations the kernel computes in their order, each rounded
# once (the two fused multiply-adds are PyTorch's add_(alpha=) and
# addcmul_(value=) on the card)
# ---------------------------------------------------------------------------


def _adam_tree(shapes, device, seed):
    """[params, grads, mu, nu] at ``shapes``: moments as after some steps
    (nu ≥ mu²), the gradients zero on about 70% of the elements, as an
    embedding table's untouched rows are."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=device)

    mu = [draw(s, 1e-3) for s in shapes]
    return [[draw(s, 0.05) for s in shapes],
            [draw(s, 1e-2) * (torch.rand(s, generator=gen, device=device)
                              < 0.3) for s in shapes],
            mu, [m * m + draw(s, 1e-3) ** 2 for s, m in zip(shapes, mu)]]


def _adam_steps(tx, tree, steps, plain, monkeypatch):
    """``steps`` updates of ``tx`` on a copy of ``tree`` (the gradients
    scaled by the step) through the kernel, or through the plain version
    in its place. → [params, mu, nu]."""
    from recsys_tpu_torch.train import optim

    p, g, m, v = ([t.clone() for t in leaves] for leaves in tree)
    state = optim.AdamState(torch.zeros((), dtype=torch.int32,
                                        device=p[0].device), m, v)
    with monkeypatch.context() as mp:
        if plain:
            mp.setattr(optim, "adam_update", au.adam_update_reference)
        for s in range(steps):
            tx.update([gi * (1.0 + 0.25 * s) for gi in g], state, p)
    torch.cuda.synchronize()
    return [p, m, v]


def _assert_leaves_equal(got, want):
    for gs, ws in zip(got, want, strict=True):
        for a, b in zip(gs, ws, strict=True):
            assert torch.equal(a, b), int((a != b).sum())


def _schedules():
    from recsys_tpu_torch.train import optim

    return {"constant": lambda: optim.adam(1e-3),
            "decay": lambda: optim.adam(1e-3, weight_decay=0.01),
            "cosine+decay": lambda: optim.adam(
                optim.cosine_decay(1e-3, 8, warmup_steps=2),
                weight_decay=0.01)}


@pytest.mark.parametrize("schedule", ["constant", "decay", "cosine+decay"])
@pytest.mark.parametrize("name", ["deepfm", "xdeepfm"])
def test_adam_kernel_is_the_plain_loop_on_the_model_trees(
        cuda_device, monkeypatch, name, schedule):
    """Full-width DeepFM's tree (15 leaves, 14,382,482 parameters) and
    xDeepFM's (25 leaves): 5 steps of ``optim.adam`` through the kernel
    bitwise equal to the same steps through the plain loop, one launch a
    step covering every leaf."""
    model = make_model(name, CriteoConfig(), ModelConfig(name=name))
    shapes = [t.shape for t in tree_util.leaves(
        model.init(torch.Generator(), "meta")[0])]
    tree = _adam_tree(shapes, cuda_device, seed=len(name))
    tx = _schedules()[schedule]()
    with cuda_build.counting() as n:
        got = _adam_steps(tx, tree, 5, False, monkeypatch)
    assert (n["adam_update"], n["adam_update.leaves"]) == (5,
                                                           5 * len(shapes))
    want = _adam_steps(tx, tree, 5, True, monkeypatch)
    _assert_leaves_equal(got, want)
    assert not torch.equal(got[0][-2], tree[0][-2])   # the big table moved


ADAM_EDGE_CASES = {
    # sizes whose last chunk is ragged: not multiples of 4
    "ragged": [(4099,), (17, 3), (4096 + 3,), (3,)],
    "one element": [(), (1,), (1, 1)],
    "empty leaf": [(5000,), (0,), (0, 17), (7,)],
    # more leaves than one launch takes (64): three launches
    "many leaves": [(1 + 37 * i,) for i in range(150)],
}


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("case", list(ADAM_EDGE_CASES))
def test_adam_kernel_edge_leaves(cuda_device, case, decay):
    """Ragged leaves, one-element and empty leaves, and more leaves than a
    launch covers: the kernel bitwise equal to the plain version, with
    one launch per 64 non-empty leaves."""
    shapes = ADAM_EDGE_CASES[case]
    tree = _adam_tree(shapes, cuda_device, seed=len(shapes))
    lr_t = torch.full((), 2.5e-3, device=cuda_device)
    lr_wd = torch.full((), 1e-5, device=cuda_device) if decay else None
    want = [[t.clone() for t in leaves] for leaves in tree]
    au.adam_update_reference(*want, lr_t, lr_wd, 0.9, 0.999, 1e-8)
    with cuda_build.counting() as n:
        au.adam_update(*tree, lr_t, lr_wd, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
    live = sum(1 for s in shapes if int(np.prod(s)) > 0)
    assert (n["adam_update"], n["adam_update.leaves"]) == (-(-live // 64),
                                                           live)
    _assert_leaves_equal(tree, want)


def test_adam_kernel_takes_views_off_alignment(cuda_device):
    """Leaves 4 bytes off 16-byte alignment (the scalar path), beside an
    aligned one (the float4 path) in the same launch: bitwise the plain
    version, and a number as lr_wd is read as the float32 the plain
    version multiplies by."""
    n = 10_001
    buffers = _adam_tree([(n + 1,)], cuda_device, seed=3)
    aligned = _adam_tree([(n,)], cuda_device, seed=4)
    tree = [[b[0][1:], a[0]] for b, a in zip(buffers, aligned)]
    assert tree[0][0].data_ptr() % 16 == 4
    want = [[t.clone() for t in leaves] for leaves in tree]
    lr_t = torch.full((), 1e-3, device=cuda_device)
    au.adam_update_reference(*want, lr_t, 3e-6, 0.9, 0.999, 1e-8)
    au.adam_update(*tree, lr_t, 3e-6, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    _assert_leaves_equal(tree, want)


def test_adam_cosine_schedule_replays_read_their_own_step(cuda_device,
                                                          monkeypatch):
    """One ``optim.adam`` update with a cosine schedule (its warm-up ends
    inside) and weight decay captured in a CUDA graph and replayed 6
    times: each replay reads its own step's rate, so the state is bitwise
    that of 6 eager updates, through the kernel and through the plain
    loop."""
    from recsys_tpu_torch.train import optim

    tree = _adam_tree([(3000, 17), (100,), (), (24, 10)], cuda_device, 9)
    tx = _schedules()["cosine+decay"]()
    _adam_steps(tx, tree, 1, False, monkeypatch)   # loads the kernel
    p, g, m, v = ([t.clone() for t in leaves] for leaves in tree)
    state = optim.AdamState(torch.zeros((), dtype=torch.int32,
                                        device=cuda_device), m, v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tx.update(g, state, p)
    for _ in range(6):
        graph.replay()
    torch.cuda.synchronize()
    assert int(state.count) == 6

    def eager(plain):
        p, g, m, v = ([t.clone() for t in leaves] for leaves in tree)
        st = optim.AdamState(torch.zeros((), dtype=torch.int32,
                                         device=cuda_device), m, v)
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(optim, "adam_update", au.adam_update_reference)
            for _ in range(6):
                tx.update(g, st, p)
        torch.cuda.synchronize()
        return [p, m, v]

    _assert_leaves_equal([p, m, v], eager(False))
    _assert_leaves_equal([p, m, v], eager(True))


@pytest.mark.parametrize("name,engine", [("deepfm", "split"),
                                         ("xdeepfm", "split"),
                                         ("wide", "split")])
def test_graphed_adam_launch_counts_are_one_a_step(cuda_device, name,
                                                   engine):
    """Under replay the Adam kernel's counters count what ran: one launch
    a step covering every leaf of the tree; none for wide, which trains
    with FTRL."""
    model, ccfg = _graph_model(name, engine)
    data = fast.stage_dataset(synthetic_criteo(4096, ccfg), cuda_device)
    ts, tx = TS.create_train_state(model, 0, 1e-3, cuda_device)
    steps = fast.make_scanned_train_step_devgen(model, tx, 4096, 512)
    n_leaves = 0 if name == "wide" else len(tree_util.leaves(ts.params))
    for c, k in enumerate((1, 7, 4)):     # capture in a call of one step
        with cuda_build.counting() as n:
            ts, _ = steps(ts, data, k, c * 7)
            torch.cuda.synchronize()
        assert (n["adam_update"], n["adam_update.leaves"]) == (
            k * (n_leaves > 0), k * n_leaves)


# ---------------------------------------------------------------------------
# the segment sum's sparse mode and DLRM's graphed step
# ---------------------------------------------------------------------------

def _identity_rows(ids):
    """The map that gives id i gradient row i."""
    return torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)


def _assert_sparse_matches(got, ids, g, v, grad_rows=None, atol=1e-4):
    """The kernel's `SparseRows` against the plain version: the same
    distinct ids, count and sentinel places bitwise; the sums within the
    plain version's tolerance (another order of float32 adds; ``atol``
    1e-3 for a run of 20,000 adds, as the dense mode's edge cases take)."""
    if grad_rows is None:
        grad_rows = _identity_rows(ids)
    ref = ss.segment_sum_sparse_reference(ids.cpu(), g.cpu(), v,
                                          grad_rows.cpu())
    count = int(got.count)
    assert count == int(ref.count)
    assert torch.equal(got.ids.cpu(), ref.ids)
    torch.testing.assert_close(got.rows[:count].cpu(), ref.rows[:count],
                               rtol=1e-5, atol=atol)


@pytest.mark.parametrize("w", [1, 8, 17, 33, 128])
@pytest.mark.parametrize("n", [1, 127, 5000, 70_001])
def test_segment_sum_sparse_kernel_matches_plain_version(cuda_device, w, n):
    gen = torch.Generator().manual_seed(w * 1000 + n)
    v = 30_000
    ids = _zipf_ids(n, v, gen).to(cuda_device)
    g = torch.randn(n, w, generator=gen).to(cuda_device)
    before = _count("segment_sum")
    got = ss.segment_sum_sparse(ids, g, v, _identity_rows(ids))
    torch.cuda.synchronize()
    assert _count("segment_sum") == before + 1
    _assert_sparse_matches(got, ids, g, v)
    again = ss.segment_sum_sparse(ids, g, v, _identity_rows(ids))
    count = int(got.count)
    assert torch.equal(got.rows[:count], again.rows[:count])   # bitwise


def test_segment_sum_sparse_kernel_edge_cases(cuda_device):
    """N = 0 (a count of 0, no launch), all-equal ids (one run across every
    chunk), ids out of range (dropped, the sentinel past the count) and a
    bag map: each id takes the pooled row it names, and the sums equal the
    broadcast rows' bitwise."""
    none = torch.zeros((0,), dtype=torch.int64, device=cuda_device)
    empty = ss.segment_sum_sparse(none, torch.zeros((0, 8),
                                  device=cuda_device), 10,
                                  _identity_rows(none))
    assert int(empty.count) == 0 and empty.rows.shape == (0, 8)
    g = torch.randn(20_000, 17, device=cuda_device)
    same = torch.full((20_000,), 9, dtype=torch.int64, device=cuda_device)
    _assert_sparse_matches(ss.segment_sum_sparse(same, g, 10,
                                                 _identity_rows(same)),
                           same, g, 10, atol=1e-3)
    gen = torch.Generator().manual_seed(7)
    ids = torch.randint(-50, 1050, (20_000,), generator=gen)
    ids[::7] = 2 ** 40
    ids = ids.to(cuda_device)
    got = ss.segment_sum_sparse(ids, g, 1000, _identity_rows(ids))
    _assert_sparse_matches(got, ids, g, 1000)
    assert int(got.ids[int(got.count)]) == 1000
    b, bags = 300, (3, 1, 100, 2)
    field = torch.repeat_interleave(torch.arange(4), torch.tensor(bags))
    rows = (torch.arange(b)[:, None] * 4 + field[None, :]).reshape(-1)
    bag_ids = torch.randint(0, 500, (b * sum(bags),), generator=gen).to(
        cuda_device)
    pooled = torch.randn(b * 4, 128, device=cuda_device)
    grad_rows = rows.to(torch.int32).to(cuda_device)
    mapped = ss.segment_sum_sparse(bag_ids, pooled, 500, grad_rows)
    _assert_sparse_matches(mapped, bag_ids, pooled, 500, grad_rows)
    broadcast = ss.segment_sum_sparse(bag_ids, pooled[grad_rows.long()],
                                      500, _identity_rows(bag_ids))
    count = int(mapped.count)
    assert torch.equal(mapped.ids, broadcast.ids)
    assert torch.equal(mapped.rows[:count], broadcast.rows[:count])


def _dlrm_config():
    """A DLRM of the cell's widths with each table cut to at most 1M rows
    (6,500,127 rows, a 3.33 GB table): dim 128, rank 512, the cell's MLPs
    and bags."""
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs",
                           "dlrm-dcnv2-criteo1tb.json")) as f:
        config = json.load(f)
    config["num_embeddings_per_feature"] = [
        min(v, 1_000_000) for v in config["num_embeddings_per_feature"]]
    return config


def test_dlrm_graphed_step_equals_the_eager_one_and_writes_no_table(
        cuda_device):
    """Three DLRM steps at batch 1,024 through the graphed K-step call and
    through the same body run eagerly, from the same weights: the losses,
    every parameter and every accumulator agree bitwise; rows no step
    touched are bitwise unchanged; the graph's capture and its replays
    allocate nothing near the table's size (a dense gradient would be one
    more table); and each step launched the sparse segment sum once and
    row-wise Adagrad once."""
    from benchmark import dlrm_data, port_dlrm
    from benchmark.kinds import devgen_dlrm_train as kind

    config = _dlrm_config()
    traffic = {"rows": 20_000, "batch": 1024, "id_skew": 2.2,
               "planted": {"bias": -1.2, "effect_scale": 0.35,
                           "dense_scale": 0.15, "interaction_rank": 4,
                           "interaction_scale": 0.14}}
    port_dlrm.build_kernels()
    data = dlrm_data.make_dataset(config, traffic, 5, cuda_device)
    states, losses = [], []
    for graphed in (True, False):
        m = port_dlrm.model(config)
        ts, tx = port_dlrm.train_state(
            m, config, kind.weights(config, 5, cuda_device), 5, cuda_device)
        table_bytes = ts.params["table"].numel() * 4
        steps = fast.make_scanned_train_step_devgen(
            m, tx, 20_000, 1024, graphed=graphed)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(cuda_device)
        torch.cuda.reset_peak_memory_stats(cuda_device)
        with cuda_build.counting() as n:
            ts, loss = steps(ts, data, 3, 0)
            torch.cuda.synchronize()
        assert n["segment_sum"] == 3 and n["rowwise_adagrad"] == 3
        assert torch.cuda.max_memory_allocated(cuda_device) - before \
            < table_bytes / 4
        states.append(ts)
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    _assert_leaves_equal([tree_util.leaves(states[0].params),
                          tree_util.leaves(states[0].opt_state.acc)],
                         [tree_util.leaves(states[1].params),
                          tree_util.leaves(states[1].opt_state.acc)])
    start = kind.weights(config, 5, cuda_device)["table"]
    untouched = states[0].opt_state.acc["table"] == 0
    assert untouched.any() and not untouched.all()
    assert torch.equal(states[0].params["table"][untouched],
                       start[untouched])
