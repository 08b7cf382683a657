"""DIN's attention unit as one autograd Function (``ops/din_attention.py``,
``csrc/din_attention.cu``) against the plain PyTorch unit
(``interactions.din_attention`` on the CPU).

On the CPU: each kernel's plain version, chained, and the Function built
from them give today's forward bitwise, from the same dropout uniforms;
their gradients agree within 1e-6 of each leaf's norm, and of hist's and
query's; eval draws nothing; the CPU path never takes the Function; the
fused backward's algebra (`fused_backward_reference`) is the plain
backward's, and the padded rows it skips add nothing to it. On the card
(marker ``gpu``, skipped without one): at the benchmark cell's shapes the
kernels' activations, weights and pooled outputs equal the plain CUDA
path's bitwise, the gradients agree within 1e-6, the fused backward
agrees with the plain one, repeats its bits and counts its tiles, a
graphed DIN step equals the eager one bitwise and the launches are
counted. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_din_attention.py
"""

import re

import pytest
import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops import din_attention as da
from recsys_tpu_torch.ops import interactions

B = 3


def _unit(seed, p, k, widths, pad, device="cpu", b=B):
    """(params, hist [b, p, k], ids [b, p], query [b, k]); ``pad``: 'all'
    positions padding, 'none', 'some' (a random share, row 0 whole), or
    'left' (histories left-aligned: example 0 all padding, example 1
    whole, the others of random lengths)."""
    gen = torch.Generator().manual_seed(seed)
    params = interactions.din_attention_init(gen, k, widths, "cpu")
    for layer in (*params["mlp"], params["out"]):
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen)
    hist = torch.randn(b, p, k, generator=gen)
    query = torch.randn(b, k, generator=gen)
    ids = torch.randint(1, 50, (b, p), generator=gen)
    if pad == "all":
        ids.zero_()
    elif pad == "some":
        ids[1:] *= torch.rand(b - 1, p, generator=gen) < 0.6
    elif pad == "left":
        lens = torch.randint(0, p + 1, (b,), generator=gen)
        lens[0], lens[1] = 0, p
        ids *= torch.arange(p)[None, :] < lens[:, None]
    to = lambda t: t.to(device)                                # noqa: E731
    params = {"mlp": [{k_: to(v) for k_, v in l.items()}
                      for l in params["mlp"]],
              "out": {k_: to(v) for k_, v in params["out"].items()}}
    return params, to(hist), to(ids), to(query)


def _leaves(params):
    return [t for layer in (*params["mlp"], params["out"])
            for t in (layer["w"], layer["b"])]


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _today(params, hist, ids, query, train, gen,
           unit=interactions.din_attention):
    """The plain unit (``din_attention`` on the CPU, or
    ``din_attention_plain`` on any device)."""
    return unit(params, hist, ids, query, train=train, dropout_rate=0.1,
                gen=gen)


def _plain_chain(params, hist, ids, query, rands, keep):
    """The plain versions chained: (out, activations, wgt)."""
    a = da.build_reference(hist, query)
    acts = []
    for layer, rand in zip(params["mlp"], rands):
        a = da.epilogue_reference(a @ layer["w"], layer["b"], rand, keep)
        acts.append(a)
    out, wgt = da.pool_reference(hist, ids, a @ params["out"]["w"],
                                 params["out"]["b"])
    return out, acts, wgt


def _rands(params, b, p, train, seed, device="cpu"):
    gen = _gen(seed, device)
    if not train:
        return [None] * len(params["mlp"]), None
    return ([torch.rand((b * p, l["w"].shape[1]), generator=gen,
                        device=device) for l in params["mlp"]], 0.9)


CASES = [pytest.param(p, k, widths, pad, id=f"P{p}-K{k}-{len(widths)}"
                      f"layer-{pad}")
         for p in (1, 7, 32, 128) for k in (16, 32)
         for widths, pad in (((12, 8), "some"), ((8,), "none"),
                             ((12, 8), "all"))]


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("p, k, widths, pad", CASES)
def test_plain_versions_and_the_function_give_todays_forward(p, k, widths,
                                                             pad, train):
    params, hist, ids, query = _unit(p * k, p, k, widths, pad)
    want = _today(params, hist, ids, query, train, _gen(7))
    rands, keep = _rands(params, B, p, train, 7)
    assert torch.equal(_plain_chain(params, hist, ids, query, rands,
                                    keep)[0], want)
    got = da.DinAttentionUnit.apply(hist, query, ids, rands, keep, None,
                                    *_leaves(params))
    assert torch.equal(got, want)
    got = da.din_attention_unit(params, hist, ids, query, train=train,
                                dropout_rate=0.1, gen=_gen(7))
    assert torch.equal(got, want)


def _grads(fn, params, hist, query):
    leaves = [t.detach().clone().requires_grad_() for t in
              (hist, query, *_leaves(params))]
    h, q, *w = leaves
    it = iter(w)
    live = {"mlp": [{"w": next(it), "b": next(it)} for _ in params["mlp"]],
            "out": {"w": next(it), "b": next(it)}}
    out = fn(live, h, q)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)
                      ).to(out.device)
    return torch.autograd.grad((out * cot).sum(), leaves)


def _close(got, want, rel=1e-6):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        scale = max(float(w.norm()), 1e-30)
        assert float((g - w).norm()) <= rel * scale, (i, float(
            (g - w).norm()) / scale)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("p, k, widths, pad", CASES)
def test_the_functions_gradients_agree_with_autograds(p, k, widths, pad,
                                                      train):
    params, hist, ids, query = _unit(p + k, p, k, widths, pad)
    want = _grads(lambda w, h, q: _today(w, h, ids, q, train, _gen(5)),
                  params, hist, query)
    got = _grads(lambda w, h, q: da.din_attention_unit(
        w, h, ids, q, train=train, dropout_rate=0.1, gen=_gen(5)),
        params, hist, query)
    if pad == "all":            # nothing reaches the MLP: exactly zero
        assert all(float(g[:1].abs().sum()) == 0 for g in got[2:-2])
    _close(got, want)


def _backward_inputs(params, hist, ids, query, seed=9):
    """(dout, hist, query, ids, wgt, ins, weights, keep) of a unit in train
    mode, as the Function's backward takes them."""
    b, p, k = hist.shape
    rands, keep = _rands(params, b, p, True, seed, hist.device)
    _, acts, wgt = _plain_chain(params, hist, ids, query, rands, keep)
    dout = torch.randn(b, k, generator=torch.Generator().manual_seed(seed)
                       ).to(hist.device)
    return (dout, hist, query, ids, wgt,
            [da.build_reference(hist, query), *acts], _leaves(params), keep)


def _tiles(ids):
    """[B, ceil(P / TILE_ROWS)]: whether each history tile holds an id."""
    b, p = ids.shape
    nt = -(-p // da.TILE_ROWS)
    return torch.nn.functional.pad(ids > 0, (0, nt * da.TILE_ROWS - p)).view(
        b, nt, da.TILE_ROWS).any(dim=-1)


def _skipped_rows(ids):
    """[B, P]: the positions of tiles that hold only padding."""
    return ~_tiles(ids).repeat_interleave(da.TILE_ROWS, dim=1)[:,
                                                              :ids.shape[1]]


@pytest.mark.parametrize("pad", ["some", "none", "all", "left"])
@pytest.mark.parametrize("p, k", [(1, 16), (7, 32), (32, 32), (45, 16),
                                  (128, 32)])
def test_the_fused_backwards_algebra_is_the_plain_backward(p, k, pad):
    """`fused_backward_reference` (the kernel's algebra: W_eff, G and s in
    place of X, padded tiles skipped) gives `_backward_plain`'s outputs
    within 1e-6 of each one's norm, zeros on the skipped tiles' rows, and
    counts the tiles that hold an id."""
    params, hist, ids, query = _unit(p * 3 + k, p, k, (12, 8), pad, b=5)
    args = _backward_inputs(params, hist, ids, query)
    d_hist, d_query, grads, (tiles, computed) = da.fused_backward_reference(
        *args)
    want = da._backward_plain(*args)
    _close([d_hist, d_query, *grads], [want[0], want[1], *want[2]])
    assert bool((d_hist[_skipped_rows(ids)] == 0).all())
    assert (tiles, computed) == (_tiles(ids).numel(), int(_tiles(ids).sum()))


@pytest.mark.parametrize("widths", [(12, 8), (8,)], ids=["2layer", "1layer"])
@pytest.mark.parametrize("pad", ["some", "left", "all"])
def test_padded_rows_add_nothing_to_the_plain_backward(pad, widths):
    """The invariant the fused backward's skip rests on: `_backward_plain`
    with the padded rows taken out of every product and sum (the real rows
    alone, each as an example of one position) gives the same weights',
    biases', w_out's and b_out's gradients and d_query within 1e-6, and
    d_hist is exactly zero on the padded rows."""
    p, k = 40, 16
    params, hist, ids, query = _unit(len(pad) + p, p, k, widths, pad, b=5)
    dout, hist, query, ids, wgt, ins, weights, keep = _backward_inputs(
        params, hist, ids, query)
    d_hist, d_query, grads = da._backward_plain(dout, hist, query, ids, wgt,
                                                ins, weights, keep)
    assert bool((d_hist[ids == 0] == 0).all())
    real = (ids > 0).reshape(-1)
    example = torch.arange(ids.shape[0]).repeat_interleave(p)[real]
    n = int(real.sum())
    r_hist, r_query, r_grads = da._backward_plain(
        dout[example], hist.reshape(-1, k)[real][:, None, :], query[example],
        ids.reshape(-1)[real][:, None], wgt[real], [t[real] for t in ins],
        weights, keep)
    want_query = torch.zeros_like(d_query).index_add_(0, example, r_query)
    _close([r_hist.reshape(n, k), want_query, *r_grads],
           [d_hist.reshape(-1, k)[real], d_query, *grads])


def test_without_hidden_layers_the_function_is_the_plain_unit():
    params, hist, ids, query = _unit(1, 9, 16, (), "some")
    want = _today(params, hist, ids, query, False, None)
    got = da.DinAttentionUnit.apply(hist, query, ids, [], None, None,
                                    *_leaves(params))
    assert torch.equal(got, want)
    _close(_grads(lambda w, h, q: da.din_attention_unit(w, h, ids, q),
                  params, hist, query),
           _grads(lambda w, h, q: _today(w, h, ids, q, False, None),
                  params, hist, query))


def test_the_masks_are_drawn_in_nn_dropouts_order():
    """Two units in a row leave the generator where the plain units leave
    it: each unit draws one uniform tensor a hidden layer, in order."""
    params, hist, ids, query = _unit(2, 5, 16, (12, 8), "some")
    gens = [_gen(11), _gen(11)]
    for _ in range(2):
        _today(params, hist, ids, query, True, gens[0])
        da.din_attention_unit(params, hist, ids, query, train=True,
                              dropout_rate=0.1, gen=gens[1])
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # eval, or a zero rate, draws nothing
    state = gens[1].get_state()
    da.din_attention_unit(params, hist, ids, query, train=False,
                          dropout_rate=0.1, gen=gens[1])
    da.din_attention_unit(params, hist, ids, query, train=True,
                          dropout_rate=0.0, gen=gens[1])
    assert torch.equal(gens[1].get_state(), state)


def test_dropout_in_train_mode_needs_a_generator():
    params, hist, ids, query = _unit(3, 4, 16, (8,), "none")
    with pytest.raises(ValueError, match="generator"):
        da.din_attention_unit(params, hist, ids, query, train=True,
                              dropout_rate=0.1, gen=None)


def test_the_cpu_path_keeps_the_plain_unit(monkeypatch):
    """CPU tensors never reach the Function, and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the Function")

    monkeypatch.setattr(da.DinAttentionUnit, "apply", refuse)
    params, hist, ids, query = _unit(4, 6, 16, (12, 8), "some")
    with cuda_build.counting() as launches:
        interactions.din_attention(params, hist, ids, query, train=True,
                                   dropout_rate=0.1, gen=_gen(1))
    assert launches["din_attention"] == 0


def test_the_keep_constants_are_float32s():
    keep, inv = da._keep32(0.9)
    assert keep == float(torch.tensor(0.9, dtype=torch.float32))
    assert inv == float(torch.tensor(1.0, dtype=torch.float32)
                        / torch.tensor(0.9, dtype=torch.float32))


def test_the_source_exports_each_entry_point_the_wrapper_binds():
    """``csrc/din_attention.cu`` (built only on the card) defines each C
    entry point with the wrapper's argument count, and its ``ROWS``,
    ``TILE``, ``LIST`` and the fused kernel's blocks an SM are the
    wrapper's `ROWS_PER_BLOCK`, `TILE_ROWS`, `FUSED_MAX_POSITIONS` and
    `FUSED_BLOCKS_PER_SM`."""
    with open(da.SOURCE) as f:
        src = f.read()
    body = src[src.index('extern "C" {'):]
    for name, args in cuda_build.signatures(da.SOURCE).items():
        m = re.search(rf"int {name}\(([^)]*)\)", body)
        assert m, name
        assert len(m.group(1).split(",")) == len(args), name
    assert re.search(rf"constexpr int ROWS = {da.ROWS_PER_BLOCK};", src)
    assert re.search(rf"constexpr int TILE = {da.TILE_ROWS};", src)
    lst = int(re.search(r"constexpr int LIST = (\d+);", src).group(1))
    assert lst * da.TILE_ROWS == da.FUSED_MAX_POSITIONS
    assert re.search(r"__launch_bounds__\(THREADS, "
                     rf"{da.FUSED_BLOCKS_PER_SM}\)", src)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cell_unit(cuda_device, pad="some", k=32, widths=(80, 40)):
    """The benchmark cell's shapes: B = 1,024, P = 128, K = 32, 80-40."""
    return _unit(21, 128, k, widths, pad, cuda_device, b=1024)


@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_kernels_equal_the_plain_cuda_path_bitwise(cuda_device, train):
    params, hist, ids, query = _cell_unit(cuda_device)
    b, p, _ = hist.shape
    rands, keep = _rands(params, b, p, train, 9, cuda_device)
    plain_out, plain_acts, plain_wgt = _plain_chain(params, hist, ids, query,
                                                    rands, keep)
    x = da.build(hist, query)
    assert torch.equal(x, da.build_reference(hist, query))
    a = x
    for layer, rand, want in zip(params["mlp"], rands, plain_acts):
        z = torch.matmul(a, layer["w"])
        assert torch.equal(da.epilogue_reference(z, layer["b"], rand, keep),
                           want)
        a = da.epilogue(z, layer["b"], rand, keep)
        assert torch.equal(a, want)
    out, wgt = da.pool(hist, ids, torch.matmul(a, params["out"]["w"]),
                       params["out"]["b"])
    assert torch.equal(wgt, plain_wgt)
    assert torch.equal(out, plain_out)
    gen = _gen(9, cuda_device)
    want = _today(params, hist, ids, query, train, gen, interactions
                  .din_attention_plain)
    got = da.din_attention_unit(params, hist, ids, query, train=train,
                                dropout_rate=0.1, gen=_gen(9, cuda_device))
    assert torch.equal(got, want)


def _err(got, want) -> float:
    """‖got − want‖ / ‖want‖ in float64 (0 where both are 0)."""
    d = float((got.double() - want.double()).norm())
    return d / max(float(want.double().norm()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", ["some", "all", "none"])
@pytest.mark.parametrize("k, widths", [(32, (80, 40)), (16, (80, 40)),
                                       (32, (36,)), (30, (21, 7))])
def test_card_gradients_agree_with_the_plain_cuda_path(cuda_device, pad, k,
                                                       widths):
    """Each gradient within 1e-6 of the plain float32 path's, beyond that
    path's own distance from the exact backward of the same forward (the
    plain backward in float64 through the float32 forward's activations,
    so through its ReLU kinks and masks), and no more than 1e-6 further
    from the exact one than the plain path is: float32 sums over 131,072
    rows, autograd's and cuBLAS's, are themselves ≈ 1e-6 off. Two runs
    bitwise equal."""
    params, hist, ids, query = _cell_unit(cuda_device, pad, k, widths)
    want = _grads(lambda w, h, q: _today(
        w, h, ids, q, True, _gen(5, cuda_device),
        interactions.din_attention_plain), params, hist, query)
    got = _grads(lambda w, h, q: da.din_attention_unit(
        w, h, ids, q, train=True, dropout_rate=0.1,
        gen=_gen(5, cuda_device)), params, hist, query)
    rands, keep = _rands(params, *ids.shape, True, 5, cuda_device)
    _, acts, wgt = _plain_chain(params, hist, ids, query, rands, keep)
    cot = torch.randn(query.shape, generator=torch.Generator().manual_seed(
        3)).to(cuda_device)
    f64 = [t.double() for t in (cot, hist, query, wgt)]
    exact = da._backward_plain(
        f64[0], f64[1], f64[2], ids, f64[3],
        [t.double() for t in (da.build_reference(hist, query), *acts)],
        [t.double() for t in _leaves(params)], keep)
    exact = [exact[0], exact[1], *exact[2]]
    for g, w, e in zip(got, want, exact, strict=True):
        assert _err(g, w) <= 1e-6 + _err(w, e)
        assert _err(g, e) <= 1e-6 + _err(w, e)
    again = _grads(lambda w, h, q: da.din_attention_unit(
        w, h, ids, q, train=True, dropout_rate=0.1,
        gen=_gen(5, cuda_device)), params, hist, query)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_launches_are_counted_per_unit(cuda_device):
    """n + 2 kernels forward a unit; backward 2 (the fused kernel and the
    column sums) at `FUSED_SHAPES`, else max(n, 1) + 2."""
    for k, widths in ((32, (80, 40)), (16, (80, 40)), (32, (36,)), (32, ()),
                      (32, (80, 36))):
        params, hist, ids, query = _unit(3, 16, k, widths, "some",
                                         cuda_device, b=64)
        n = len(widths)
        fused = (k, *widths) in da.FUSED_SHAPES
        with cuda_build.counting() as launches, torch.no_grad():
            da.din_attention_unit(params, hist, ids, query)
        assert launches["din_attention"] == n + 2
        with cuda_build.counting() as launches:
            _grads(lambda w, h, q: da.din_attention_unit(
                w, h, ids, q, train=True, dropout_rate=0.1,
                gen=_gen(5, cuda_device)), params, hist, query)
            torch.cuda.synchronize()
        assert launches["din_attention"] == (n + 2) + (
            2 if fused else max(n, 1) + 2)


@pytest.mark.gpu
def test_a_graphed_din_call_equals_the_eager_steps_and_counts_replays(
        cuda_device):
    """DIN at the cell's widths (K = 32, 80-40, dropout 0.1), B = 256,
    P = 32: two devgen calls of K = 5, graphed and eager, bitwise; the
    launches of the graphed call are the eager call's (12 a step: each
    unit's four forward kernels, its fused backward and column sums)."""
    from recsys_tpu_torch.core import tree as tree_util
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.data import amazon
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    ds = amazon.synthetic_din(n_users=400, item_vocab=500, cate_vocab=20,
                              seed=2)
    data = fast.stage_dataset(
        {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
         "hist_cate": ds.hist_cate, "label": ds.label}, cuda_device)
    out = {}
    for graphed in (False, True):
        model = make_model("din", 500, 20, ModelConfig(
            name="din", embedding_dim=32, use_bn=False, dropout=0.1))
        ts, tx = TS.create_train_state(model, 4, 1e-3, cuda_device)
        steps = fast.make_scanned_train_step_devgen(
            model, tx, data["label"].shape[0], 256, graphed=graphed)
        ts, _ = steps(ts, data, 5, 0)           # the capture
        torch.cuda.synchronize()
        with cuda_build.counting() as launches:
            ts, loss = steps(ts, data, 5, 5)
            torch.cuda.synchronize()
        out[graphed] = (loss, tree_util.leaves(
            (ts.params, ts.model_state, ts.opt_state)),
            launches["din_attention"])
    (l_e, t_e, n_e), (l_g, t_g, n_g) = out[False], out[True]
    assert torch.equal(l_e, l_g)
    for a, b in zip(t_e, t_g, strict=True):
        assert torch.equal(a, b)
    assert n_e == n_g == 5 * 2 * 6


@pytest.mark.gpu
@pytest.mark.parametrize("pad", ["left", "some", "none"])
@pytest.mark.parametrize("b, p", [(1024, 128), (1024, 32)],
                         ids=["cell", "smoke"])
def test_the_fused_backward_agrees_with_the_plain_backward_on_the_card(
        cuda_device, b, p, pad):
    """At the DIN cell's unit (B = 1,024, P = 128, K = 32, 80-40, dropout
    0.1) and at ``chip_smoke.py``'s DIN training (P = 32), with
    left-aligned padding (an example all padding, one whole), padding
    scattered inside the histories, or none: `fused_backward_kernel`
    within the file's tolerances of `_backward_plain` on the card (1e-6
    beyond the plain path's own distance from the float64 backward), exact
    zeros on the skipped tiles' rows of d_hist, the same bits in a second
    run and in a graph's replay, and its tile counter at the tiles that
    hold a nonzero id."""
    params, hist, ids, query = _unit(p + len(pad), p, 32, (80, 40), pad,
                                     cuda_device, b=b)
    args = _backward_inputs(params, hist, ids, query)
    assert da.fused(hist, args[5], args[6])
    tiles = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    d_hist, d_query, grads = da.fused_backward_kernel(*args, tiles)
    got = [d_hist, d_query, *grads]
    want = da._backward_plain(*args)
    want = [want[0], want[1], *want[2]]
    dout, hist_, query_, ids_, wgt, ins, weights, keep = args
    exact = da._backward_plain(
        dout.double(), hist_.double(), query_.double(), ids_, wgt.double(),
        [t.double() for t in ins], [t.double() for t in weights], keep)
    exact = [exact[0], exact[1], *exact[2]]
    for g, w, e in zip(got, want, exact, strict=True):
        assert _err(g, w) <= 1e-6 + _err(w, e)
        assert _err(g, e) <= 1e-6 + _err(w, e)
    assert bool((d_hist[_skipped_rows(ids)] == 0).all())
    computed = _tiles(ids)
    assert tiles.tolist() == [computed.numel(), int(computed.sum())]
    again = da.fused_backward_kernel(*args)
    assert all(torch.equal(a, c) for a, c in
               zip(got, [again[0], again[1], *again[2]], strict=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.fused_backward_kernel(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = da.fused_backward_kernel(*args, tiles)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(
        got, [replayed[0], replayed[1], *replayed[2]], strict=True))
    assert tiles.tolist() == [3 * computed.numel(), 3 * int(computed.sum())]


@pytest.mark.gpu
def test_a_din_step_counts_its_backward_tiles(cuda_device):
    """DIN's ``meta['backward_tiles']`` after graphed devgen steps: each
    step's two units add the batch's tiles and those that hold an id, as
    an eager step does."""
    from recsys_tpu_torch.core.config import ModelConfig
    from recsys_tpu_torch.data import amazon
    from recsys_tpu_torch.models.api import make_model
    from recsys_tpu_torch.train import fast
    from recsys_tpu_torch.train import train_state as TS

    ds = amazon.synthetic_din(n_users=300, item_vocab=500, cate_vocab=20,
                              seed=3)
    data = fast.stage_dataset(
        {"i_id": ds.i_id, "i_cate": ds.i_cate, "hist_iid": ds.hist_iid,
         "hist_cate": ds.hist_cate, "label": ds.label}, cuda_device)
    totals = {}
    for graphed in (False, True):
        model = make_model("din", 500, 20, ModelConfig(
            name="din", embedding_dim=32, use_bn=False, dropout=0.1))
        ts, tx = TS.create_train_state(model, 4, 1e-3, cuda_device)
        steps = fast.make_scanned_train_step_devgen(
            model, tx, data["label"].shape[0], 128, graphed=graphed)
        steps(ts, data, 4, 0)
        totals[graphed] = model.meta["backward_tiles"].totals(cuda_device)
    p = data["hist_iid"].shape[1]
    assert totals[False] == totals[True]
    assert totals[True]["tiles"] == 4 * 2 * 128 * -(-p // da.TILE_ROWS)
    assert 0 < totals[True]["computed"] <= totals[True]["tiles"]
