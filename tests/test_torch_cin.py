"""The port's CIN against the JAX package's, on the same numpy inputs.

On the CPU the port's `cin_layer` takes its plain version; the JAX side runs
the fused Pallas kernel in interpret mode (as tests/test_pallas_cin.py does)
and the XLA formulation. Tolerance 1e-5 absolute and relative, as in
tests/test_pallas_cin.py: 1521-term float32 sums in another order.

The CUDA kernel itself runs only on a card: tests/test_torch_gpu.py
compares it with the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops import interactions as jinter
from recsys_tpu.ops import pallas_cin
from recsys_tpu_torch.ops import cin_kernel
from recsys_tpu_torch.ops import interactions as tinter

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(rng, f0, layer_sizes):
    params, fk = [], f0
    for h in layer_sizes:
        lim = (6.0 / (f0 * fk + h)) ** 0.5
        params.append({
            "w": rng.uniform(-lim, lim, (f0 * fk, h)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(h)).astype(np.float32),
        })
        fk = h
    return params


def _both(params, x0):
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in params]
    tp = [{k: torch.from_numpy(v) for k, v in layer.items()}
          for layer in params]
    return jp, jnp.asarray(x0), tp, torch.from_numpy(x0)


@pytest.mark.parametrize("b,f0,d,layer_sizes", [
    (4, 39, 16, (4,)),
    (4, 39, 16, (5, 3)),
    (4, 39, 16, (20, 10, 10)),
    (3, 39, 7, (20, 10, 10)),     # ragged N = 21: not a multiple of any tile
])
def test_cin_apply_matches_jax(b, f0, d, layer_sizes):
    rng = np.random.default_rng(sum(layer_sizes) + b)
    params = _params(rng, f0, layer_sizes)
    x0 = rng.standard_normal((b, f0, d)).astype(np.float32)
    jp, jx, tp, tx = _both(params, x0)
    got = tinter.cin_apply(tp, tx).numpy()
    assert got.shape == (b, sum(layer_sizes))
    np.testing.assert_allclose(got, np.asarray(pallas_cin.cin_apply_fused(jp, jx)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(jinter.cin_apply_xla(jp, jx)),
                               **TOL)


def test_cin_layer_matches_pallas_layer():
    rng = np.random.default_rng(7)
    n, f0, fk, h = 300, 39, 20, 10
    x0v = rng.standard_normal((n, f0)).astype(np.float32)
    xkv = rng.standard_normal((n, fk)).astype(np.float32)
    layer = _params(rng, f0, (fk, h))[1]
    ref = pallas_cin.cin_layer(jnp.asarray(x0v), jnp.asarray(xkv),
                               jnp.asarray(layer["w"]), jnp.asarray(layer["b"]))
    got = cin_kernel.cin_layer(torch.from_numpy(x0v), torch.from_numpy(xkv),
                               torch.from_numpy(layer["w"]),
                               torch.from_numpy(layer["b"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cin_init_shapes_match_jax():
    jp = jinter.cin_init(jax.random.key(0), 39, (20, 10, 10))
    tp = tinter.cin_init(torch.Generator().manual_seed(0), 39, (20, 10, 10),
                         "cpu")
    assert [tuple(l["w"].shape) for l in tp] == [l["w"].shape for l in jp]
    assert all(float(l["b"].abs().sum()) == 0.0 for l in tp)


def test_fm_pairwise_from_sums_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((6, 8)).astype(np.float32)
    sq = rng.uniform(0, 3, (6, 8)).astype(np.float32)
    ref = jinter.fm_pairwise_from_sums(jnp.asarray(s), jnp.asarray(sq))
    got = tinter.fm_pairwise_from_sums(torch.from_numpy(s), torch.from_numpy(sq))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape", "wide_h"])
def test_cin_layer_rejects_what_the_kernel_does_not_take(bad):
    x0v, xkv = torch.randn(8, 5), torch.randn(8, 3)
    w, b = torch.randn(15, 4), torch.randn(4)
    if bad == "dtype":
        x0v = x0v.double()
    elif bad == "contiguous":
        xkv = torch.randn(3, 8).t()
    elif bad == "shape":
        w = torch.randn(14, 4)
    else:
        w, b = torch.randn(15, 33), torch.randn(33)
    with pytest.raises((TypeError, ValueError)):
        cin_kernel.cin_layer(x0v, xkv, w, b)


def test_cpu_tensors_take_the_plain_version_without_counting():
    cin_kernel.LAUNCHES = 0
    x0v = torch.randn(16, 5)
    w, b = torch.randn(25, 4), torch.randn(4)
    out = cin_kernel.cin_layer(x0v, x0v, w, b)
    torch.testing.assert_close(
        out, cin_kernel.cin_layer_reference(x0v, x0v, w, b), rtol=0, atol=0)
    assert cin_kernel.LAUNCHES == 0
