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
from recsys_tpu_torch.ops import cin_kernel, cuda_build
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


@pytest.mark.parametrize("f0,fk,h,seed", [(39, 39, 20, 46), (39, 20, 10, 7),
                                          (39, 10, 10, 17)])
def test_cin_layer_matches_pallas_layer(f0, fk, h, seed):
    """Each layer shape of full-width xDeepFM against K3f
    (``pallas_cin.cin_layer``, interpret mode on the CPU)."""
    rng = np.random.default_rng(seed)
    n = 300
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
    x0v = torch.randn(16, 5)
    w, b = torch.randn(25, 4), torch.randn(4)
    with cuda_build.counting() as launches:
        out = cin_kernel.cin_layer(x0v, x0v, w, b)
    torch.testing.assert_close(
        out, cin_kernel.cin_layer_reference(x0v, x0v, w, b), rtol=0, atol=0)
    assert launches["cin_fwd"] == 0


@pytest.mark.parametrize("n,fk,h", [(300, 20, 10), (37, 39, 5), (256, 10, 3)])
def test_cin_backward_matches_pallas_backward(n, fk, h):
    """The plain backward against K3b (``pallas_cin._bwd_impl``) in
    interpret mode, from the same forward output and output gradient."""
    rng = np.random.default_rng(n + fk)
    f0 = 39
    x0v = rng.standard_normal((n, f0)).astype(np.float32)
    xkv = rng.standard_normal((n, fk)).astype(np.float32)
    layer = _params(rng, f0, (fk, h))[1]
    dy = rng.standard_normal((n, h)).astype(np.float32)
    y = cin_kernel.cin_layer_reference(
        torch.from_numpy(x0v), torch.from_numpy(xkv),
        torch.from_numpy(layer["w"]), torch.from_numpy(layer["b"]))
    assert 0 < float((y > 0).float().mean()) < 1   # the mask matters
    got = cin_kernel.cin_layer_bwd(
        torch.from_numpy(x0v), torch.from_numpy(xkv),
        torch.from_numpy(layer["w"]), y, torch.from_numpy(dy))
    ref = pallas_cin._bwd_impl(jnp.asarray(x0v), jnp.asarray(xkv),
                               jnp.asarray(layer["w"]), jnp.asarray(y.numpy()),
                               jnp.asarray(dy))
    for name, g, r in zip(("dx0", "dxk", "dw", "db"), got, ref):
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   rtol=1e-5, atol=5e-5)


@pytest.mark.parametrize("n,f0,fk", [
    (1, 39, 39), (63, 39, 20), (64, 39, 10), (3333, 39, 39),
    (16 * 4096, 39, 39), (16 * 4096, 39, 20), (16 * 4096, 39, 10),
    (10 ** 6, 5, 1), (2 ** 31 // 39, 39, 39)])
def test_dw_groups_cover_n_and_depend_on_the_shape_alone(n, f0, fk):
    """The dW pass's row groups cover every row once, none is empty, the
    group count fits a CUDA grid, and the split is a function of the shape
    alone (the partial sums' order, hence the result, is fixed for a
    shape). At the main path's N every one of the H100's 132 SMs gets at
    least one group."""
    groups, rows = cin_kernel._dw_groups(n, f0, fk)
    assert 1 <= groups <= 65535 and rows >= 1
    assert (groups - 1) * rows < n <= groups * rows
    assert cin_kernel._dw_groups(n, f0, fk) == (groups, rows)
    if n == 16 * 4096:
        assert groups >= 132


@pytest.mark.parametrize("f0,fk,h", [(39, 39, 20), (39, 20, 10), (39, 10, 10),
                                     (5, 1, 1), (7, 13, 32)])
def test_workspace_holds_the_dw_partials_and_the_staged_w(f0, fk, h):
    """One row group's dW partial sums ([H][tile][4]: 4 columns of z a
    tile, the last tile of each p padded, plus the bias tile) hold each of
    the F0·Fk columns and the bias once for every h, in whole float4s; the
    staged W ([pass][F0][H][8]) holds every weight, in whole float4s."""
    floats = cin_kernel._dw_part_floats(f0, fk, h)
    tiles = f0 * -(-fk // 4) + 1
    assert floats == h * tiles * 4
    assert floats % 4 == 0 and floats >= (f0 * fk + 1) * h
    assert floats - (f0 * fk + 1) * h < 4 * f0 * h + 4 * h   # padding only
    wt = cin_kernel._wt_floats(f0, fk, h)
    passes = -(-(-(-fk // 4)) // 2)          # lane pairs of 4-q tiles
    assert wt == passes * f0 * h * 8 and wt % 4 == 0
    assert f0 * fk * h <= wt < f0 * (fk + 8) * h


@pytest.mark.parametrize("layer_sizes", [(5, 3), (20, 10, 10)])
def test_cin_apply_gradients_match_jax(layer_sizes):
    """Autograd through the port's `cin_layer` Function (plain versions on
    the CPU) against ``jax.grad`` of the XLA formulation ``cin_apply_xla``;
    x0 feeds every layer, so its gradient sums over the layers."""
    b, f0, d = 6, 39, 4
    rng = np.random.default_rng(len(layer_sizes))
    params = _params(rng, f0, layer_sizes)
    x0 = rng.standard_normal((b, f0, d)).astype(np.float32)
    wts = rng.standard_normal((b, sum(layer_sizes))).astype(np.float32)
    jp, jx, tp, tx = _both(params, x0)

    def jloss(p, x):
        return jnp.sum(jinter.cin_apply_xla(p, x) * wts)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tp = [{k: v.requires_grad_() for k, v in layer.items()} for layer in tp]
    tx.requires_grad_()
    with cuda_build.counting() as launches:
        (tinter.cin_apply(tp, tx) * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for tl, jl in zip(tp, jgp):
        for k in ("w", "b"):
            np.testing.assert_allclose(tl[k].grad.numpy(), np.asarray(jl[k]),
                                       rtol=1e-5, atol=5e-5, err_msg=k)
    assert launches["cin_bwd"] == 0   # CPU tensors: the plain backward


_SASS = """
        code for sm_90a
                Function : _Z6kernelv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R0] ;
        /*0020*/                   LDS.128 R4, [R0+0x10] ;
        /*0030*/                   FFMA R8, R2, R4, R8 ;
        /*0040*/                   FFMA R9, R2, R5, R9 ;
        /*0050*/                   FFMA R10, R2, R6, R10 ;
        /*0060*/                   FMUL R3, R2, R2 ;
        /*0070*/              @!P0 BRA 0x10 ;
        /*0080*/                   LDS R2, [R0] ;
        /*0090*/                   FFMA R8, R2, R2, R8 ;
        /*00a0*/               @P1 BRA 0x80 ;
        /*00b0*/                   BRA 0x0 ;
        /*00c0*/                   EXIT ;
                Function : _Z5otherv
        /*0000*/                   FFMA R8, R2, R2, R8 ;
        /*0010*/                   BRA 0x20 ;
        /*0020*/                   EXIT ;
"""


def test_sass_loops_counts_the_innermost_loop_with_the_most_ffma():
    """Of the loops that hold no other loop (the outer one, 0x0-0xb0, holds
    both), the one with the most FFMAs; a forward branch is no loop."""
    from recsys_tpu_torch.tools import sass_loops

    loops = sass_loops.inner_loops(_SASS)
    assert loops == {"_Z6kernelv": {"lds": 2, "ffma": 3, "fmul": 1,
                                    "insns": 7, "ffma_per_lds": 1.5}}


def test_sass_loops_reads_each_built_source(monkeypatch, capsys):
    """One JSON line per source given (the CIN forward's by default), from
    the SASS of the library that `cuda_build` built for it."""
    import json
    import subprocess

    from recsys_tpu_torch.ops import cuda_build
    from recsys_tpu_torch.tools import sass_loops

    built, dumped = [], []
    monkeypatch.setattr(cuda_build, "build_all", lambda srcs: built.extend(
        srcs) or [s + ".so" for s in srcs])
    monkeypatch.setattr(sass_loops, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: dumped.append(
        cmd) or subprocess.CompletedProcess(cmd, 0, stdout=_SASS))
    out = sass_loops.main([])
    assert built == [cin_kernel.SOURCE]
    assert dumped == [["cuobjdump", "-sass", cin_kernel.SOURCE + ".so"]]
    assert [json.loads(line) for line in
            capsys.readouterr().out.splitlines()] == out
    assert out[0]["inner_loops"]["_Z6kernelv"]["ffma"] == 3
    assert sass_loops.main(["a.cu", "b.cu"])[1]["source"] == "b.cu"
