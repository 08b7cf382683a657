"""DIN's attention unit as one autograd Function (``ops/din_attention.py``,
``csrc/din_attention.cu``) against the plain PyTorch unit
(``interactions.din_attention`` on the CPU).

On the CPU: each kernel's plain version, chained, and the Function built
from them give today's forward bitwise, from the same dropout uniforms;
their gradients agree within 1e-6 of each leaf's norm, and of hist's and
query's; eval draws nothing; the CPU path never takes the Function. On the
card (marker ``gpu``, skipped without one): at the benchmark cell's shapes
the kernels' activations, weights and pooled outputs equal the plain
CUDA path's bitwise, the gradients agree within 1e-6, a graphed DIN step
equals the eager one bitwise and the launches are counted. This file
imports neither jax nor the JAX package:

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
    positions padding, 'none', or 'some' (a random share, row 0 whole)."""
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
    got = da.DinAttentionUnit.apply(hist, query, ids, rands, keep,
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


def test_without_hidden_layers_the_function_is_the_plain_unit():
    params, hist, ids, query = _unit(1, 9, 16, (), "some")
    want = _today(params, hist, ids, query, False, None)
    got = da.DinAttentionUnit.apply(hist, query, ids, [], None,
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
    entry point with the wrapper's argument count, and its ``ROWS`` is the
    wrapper's `ROWS_PER_BLOCK`."""
    with open(da.SOURCE) as f:
        src = f.read()
    body = src[src.index('extern "C" {'):]
    for name, args in cuda_build.signatures(da.SOURCE).items():
        m = re.search(rf"int {name}\(([^)]*)\)", body)
        assert m, name
        assert len(m.group(1).split(",")) == len(args), name
    assert re.search(rf"constexpr int ROWS = {da.ROWS_PER_BLOCK};", src)


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
    """n + 2 kernels forward and max(n, 1) + 2 backward a unit."""
    for widths in ((80, 40), (36,), ()):
        params, hist, ids, query = _unit(3, 16, 32, widths, "some",
                                         cuda_device, b=64)
        n = len(widths)
        with cuda_build.counting() as launches, torch.no_grad():
            da.din_attention_unit(params, hist, ids, query)
        assert launches["din_attention"] == n + 2
        with cuda_build.counting() as launches:
            _grads(lambda w, h, q: da.din_attention_unit(
                w, h, ids, q, train=True, dropout_rate=0.1,
                gen=_gen(5, cuda_device)), params, hist, query)
            torch.cuda.synchronize()
        assert launches["din_attention"] == (n + 2) + (max(n, 1) + 2)


@pytest.mark.gpu
def test_a_graphed_din_call_equals_the_eager_steps_and_counts_replays(
        cuda_device):
    """DIN at the cell's widths (K = 32, 80-40, dropout 0.1), B = 256,
    P = 32: two devgen calls of K = 5, graphed and eager, bitwise; the
    launches of the graphed call are the eager call's (16 a step)."""
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
    assert n_e == n_g == 5 * 2 * 8
