"""The port's row gather (the forward of every embedding-table read) against
the JAX package's table read, on the same numpy tables and ids.

On the CPU the port's `row_gather` takes its plain version; the JAX side
is ``recsys_tpu.embeddings.table.table_gather``, which off the TPU is
``jnp.take`` (the TPU prototype ``scratch/rowdma_kernel.py`` computes the
same ``out[i] = src[ids[i]]`` with per-row DMAs and runs only on a TPU). A
gather is a copy, so the results must be bitwise equal. The gradient of
`table.table_gather` is held against ``jax.grad`` of the same read, within
1e-6 (float32 sums of the same terms in another order).

The CUDA kernel runs only on a card: tests/test_torch_gpu.py compares it
with the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.embeddings import table as jtable
from recsys_tpu_torch.embeddings import table
from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops import row_gather as rg


@pytest.mark.parametrize("v,w,n", [
    (300, 1, 1000),       # W = 1
    (2048, 17, 3333),     # the Criteo row width (D+1), ragged N
    (500, 32, 4096),      # DIN's row width, N >> V
    (64, 32, 0),          # N = 0
    (5, 17, 1),
])
def test_row_gather_matches_jax_take(v, w, n):
    rng = np.random.default_rng(v + w + n)
    src = rng.standard_normal((v, w)).astype(np.float32)
    ids = rng.integers(0, v, n)
    if n >= 2:
        ids[:2] = [0, v - 1]                 # the first and the last row
    got = rg.row_gather(torch.from_numpy(src), torch.from_numpy(ids))
    want = np.asarray(jtable.table_gather(jnp.asarray(src),
                                          jnp.asarray(ids, jnp.int32)))
    assert got.shape == (n, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_gather_matches_jax_forward_and_gradient():
    rng = np.random.default_rng(1)
    src = rng.standard_normal((400, 32)).astype(np.float32)
    ids = rng.integers(0, 400, (16, 8))
    ids[:, 5:] = 0                          # DIN's padding id: a hot row
    wts = rng.standard_normal((16, 8, 32)).astype(np.float32)

    def jloss(t):
        return jnp.sum(jtable.table_gather(t, jnp.asarray(ids)) * wts)

    jg = jax.grad(jloss)(jnp.asarray(src))
    live = torch.from_numpy(src).requires_grad_()
    rows = table.table_gather(live, torch.from_numpy(ids))
    assert rows.shape == (16, 8, 32)
    np.testing.assert_array_equal(rows.detach().numpy(), src[ids])
    (rows * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(live.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([3, 0, 3])
    with cuda_build.counting() as launches:
        out = rg.row_gather(src, ids)
    assert torch.equal(out, src[[3, 0, 3]])
    assert launches["row_gather"] == 0
    assert rg.row_gather(src, ids[:0]).shape == (0, 3)
    with pytest.raises(IndexError):          # the plain version raises
        rg.row_gather(src, torch.tensor([4]))


def test_no_kernel_for_other_devices():
    src = torch.empty((4, 3), device="meta")
    ids = torch.zeros(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rg.row_gather(src, ids)


@pytest.mark.parametrize("bad", ["table_dtype", "ids_dtype", "table_dim",
                                 "ids_dim", "contiguous", "devices",
                                 "empty"])
def test_row_gather_rejects_what_the_kernel_does_not_take(bad):
    src, ids = torch.ones(6, 4), torch.tensor([0, 5, 2])
    if bad == "table_dtype":
        src = src.double()
    elif bad == "ids_dtype":
        ids = ids.int()
    elif bad == "table_dim":
        src = src.reshape(-1)
    elif bad == "ids_dim":
        ids = ids.reshape(3, 1)
    elif bad == "contiguous":
        src = torch.ones(4, 6).t()
    elif bad == "devices":
        ids = ids.to("meta")
    else:
        src = torch.ones(0, 4)
    with pytest.raises((TypeError, ValueError)):
        rg.row_gather(src, ids)
