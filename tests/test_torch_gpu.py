"""The port on the card: the CUDA kernels (CIN forward and backward,
segment sum, row gather, the reshape probes) against their plain versions
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
from recsys_tpu_torch.ops import cin_kernel
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
    before = cin_kernel.LAUNCHES
    got = cin_kernel.cin_layer(x0v, xkv, w, b)
    torch.cuda.synchronize()
    assert cin_kernel.LAUNCHES == before + 1
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
    before = cin_kernel.LAUNCHES
    _assert_fwd_matches_and_repeats(args)
    assert cin_kernel.LAUNCHES == before + 2 * (n > 0)


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
    before = cin_kernel.LAUNCHES
    got = Servable(str(tmp_path), device="cuda").predict(feats)
    assert cin_kernel.LAUNCHES == before + 3
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
    before = cin_kernel.BWD_LAUNCHES
    got = cin_kernel.cin_layer_bwd(x0v, xkv, w, y, dy)
    torch.cuda.synchronize()
    assert cin_kernel.BWD_LAUNCHES == before + 1
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
    before = cin_kernel.BWD_LAUNCHES
    got = cin_kernel.cin_layer_bwd(*args)
    torch.cuda.synchronize()
    assert cin_kernel.BWD_LAUNCHES == before + (n > 0)
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

    fwd, bwd = cin_kernel.LAUNCHES, cin_kernel.BWD_LAUNCHES
    got = grads(cin_kernel.cin_layer)
    assert cin_kernel.LAUNCHES == fwd + 3
    assert cin_kernel.BWD_LAUNCHES == bwd + 3
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
    before = ss.LAUNCHES
    got = ss.segment_sum(ids, g, v)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
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
    before = ss.LAUNCHES
    empty = ss.segment_sum(one[:0], g[:0], 10)
    assert empty.shape == (10, 17) and not empty.any()
    assert ss.LAUNCHES == before          # N = 0 launches no kernel
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
    lib, calls = ss._lib(), []

    class Counted:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(ss, "_lib", lambda: Counted())
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
    for dev in ("cpu", cuda_device):
        ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
        counts = (ss.LAUNCHES, cin_kernel.BWD_LAUNCHES)
        ts, loss = fast.make_scanned_train_step(model, tx)(
            ts, fast.stage_dataset(data, dev), idx)
        out[str(dev)] = (float(loss), ts.params)
    assert ss.LAUNCHES - counts[0] == 6
    assert cin_kernel.BWD_LAUNCHES - counts[1] == (9 if name == "xdeepfm"
                                                   else 0)
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
    before = rg.LAUNCHES
    got = rg.row_gather(table, ids)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == before + (1 if n else 0)
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
    before = (rg.LAUNCHES, ss.LAUNCHES)
    got = sv.predict(feats)
    assert (rg.LAUNCHES - before[0], ss.LAUNCHES - before[1]) == (5, 0)
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
    for dev in ("cpu", cuda_device):
        ts, tx = TS.create_train_state(model, 0, 1e-3, dev)
        step = TS.make_train_step(model, tx)
        counts = (rg.LAUNCHES, ss.LAUNCHES)
        for b in batches:
            ts, loss = step(ts, fast.stage_dataset(b, dev))
        out[str(dev)] = (float(loss), ts.params)
    assert ss.LAUNCHES - counts[1] == 15          # 5 table reads per step
    assert rg.LAUNCHES - counts[0] == 15
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
    for dev in ("cpu", cuda_device):
        ts, tx = TS.create_train_state(model, 0, lr, dev)
        counts = (rg.LAUNCHES, ss.LAUNCHES)
        ts, loss = fast.make_scanned_train_step(model, tx)(
            ts, fast.stage_dataset(data, dev), idx)
        out[str(dev)] = (float(loss), ts.params)
    assert (rg.LAUNCHES - counts[0], ss.LAUNCHES - counts[1]) == (3 * reads,
                                                                  3 * reads)
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
    before = (rg.LAUNCHES, ss.LAUNCHES)
    got = sv.predict(feats)
    assert (rg.LAUNCHES - before[0], ss.LAUNCHES - before[1]) == (2, 0)
    ref = Servable(str(tmp_path), device="cpu").predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("vp,w", [(837_632, 17), (1001, 17), (3, 1)])
def test_reshape_probes_equal_their_plain_version(cuda_device, vp, w):
    gen = torch.Generator().manual_seed(vp)
    flat = torch.randn(vp * w, generator=gen).to(cuda_device)
    before = (rp.VIA_RESHAPE_LAUNCHES, rp.VIA_2D_LAUNCHES)
    got_flat = rp.via_reshape(flat, w)
    got_2d = rp.via_2d(flat.view(vp, w))
    torch.cuda.synchronize()
    assert (rp.VIA_RESHAPE_LAUNCHES - before[0],
            rp.VIA_2D_LAUNCHES - before[1]) == (1, 1)
    want = rp.reshape_probe_reference(flat, w)
    assert torch.equal(got_flat, want) and torch.equal(got_2d, want)
    # 4 bytes off 16-byte alignment: the scalar path
    shifted = flat[1:1 + (vp - 1) * w]
    assert torch.equal(rp.via_reshape(shifted, w),
                       rp.reshape_probe_reference(shifted, w))


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


def _kernel_counts():
    return np.array([ss.LAUNCHES, rg.LAUNCHES, cin_kernel.LAUNCHES,
                     cin_kernel.BWD_LAUNCHES])


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
        before = (rg.LAUNCHES, cin_kernel.LAUNCHES, ss.LAUNCHES)
        got = sv.predict(feats)
        torch.cuda.synchronize()
        assert (rg.LAUNCHES - before[0], cin_kernel.LAUNCHES - before[1],
                ss.LAUNCHES - before[2]) == (rows, cin, 0)
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
        before = rg.LAUNCHES
        sv.predict(feats)                       # a replay
        assert rg.LAUNCHES - before == 5
