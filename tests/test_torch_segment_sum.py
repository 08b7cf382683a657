"""The port's segment sum (the embedding-gradient scatter) against the JAX
package's Pallas kernels, on the same numpy ids and gradients.

On the CPU the port's `segment_sum` takes its plain version; the JAX side
runs ``embedding_grad_T`` (K1, W-major output, transposed back here) and
``embedding_grad`` (K2, row-major) in interpret mode, as
tests/test_pallas_kernels.py runs them. Tolerance 1e-5 absolute and
relative, as there: float32 sums of the same terms in another order (the
Pallas kernels sum by one-hot matmuls).

The CUDA kernel runs only on a card: tests/test_torch_gpu.py compares it
with the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recsys_tpu.ops import pallas_kernels as pk
from recsys_tpu_torch.embeddings import table
from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops import segment_sum as ss

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,w,v", [
    (1000, 17, 2048),     # ragged N, duplicates
    (64, 17, 2048),       # N << V: most rows untouched
    (4096, 8, 1024),      # N >> V: long segments
    (700, 5, 1024),       # ragged N and W
])
def test_segment_sum_matches_pallas(n, w, v):
    rng = np.random.default_rng(n + w)
    ids = rng.integers(0, v, n)
    ids[: n // 4] = 3           # one hot row with a long segment
    g = rng.standard_normal((n, w)).astype(np.float32)
    got = ss.segment_sum(torch.from_numpy(ids), torch.from_numpy(g), v)
    assert got.shape == (v, w) and got.dtype == torch.float32
    k1 = pk.embedding_grad_T(jnp.asarray(ids, jnp.int32), jnp.asarray(g), v)
    k2 = pk.embedding_grad(jnp.asarray(ids, jnp.int32), jnp.asarray(g), v)
    np.testing.assert_allclose(got.numpy(), np.asarray(k1).T, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(k2), **TOL)
    untouched = np.setdiff1d(np.arange(v), ids)
    assert not got.numpy()[untouched].any()


def test_table_gather_backward_is_the_segment_sum():
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((300, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, (40, 7)))
    weights = torch.from_numpy(rng.standard_normal((40, 7, 6)).astype(
        np.float32))
    live = t.clone().requires_grad_()
    rows = table.table_gather(live, ids)
    torch.testing.assert_close(rows, t[ids], rtol=0, atol=0)
    (rows * weights).sum().backward()
    torch.testing.assert_close(
        live.grad, ss.segment_sum_reference(ids.reshape(-1),
                                            weights.reshape(-1, 6), 300),
        rtol=0, atol=0)
    plain = t.clone().requires_grad_()
    (plain[ids] * weights).sum().backward()
    torch.testing.assert_close(live.grad, plain.grad, rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_counting():
    ids = torch.tensor([2, 0, 2])
    g = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    with cuda_build.counting() as launches:
        out = ss.segment_sum(ids, g, 4)
    torch.testing.assert_close(
        out, torch.tensor([[2., 3.], [0., 0.], [4., 6.], [0., 0.]]))
    assert launches["segment_sum"] == 0
    assert not ss.segment_sum(ids[:0], g[:0], 4).any()


@pytest.mark.parametrize("bad", ["ids_dtype", "grads_dtype", "shape",
                                 "contiguous", "rows", "ids_contiguous"])
def test_segment_sum_rejects_what_the_kernel_does_not_take(bad):
    ids, g, rows = torch.tensor([0, 1, 1]), torch.ones(3, 4), 2
    if bad == "ids_dtype":
        ids = ids.int()
    elif bad == "grads_dtype":
        g = g.double()
    elif bad == "shape":
        g = torch.ones(4, 4)
    elif bad == "contiguous":
        g = torch.ones(4, 3).t()
    elif bad == "ids_contiguous":
        ids = torch.tensor([0, 9, 1, 9, 1, 9])[::2]
    else:
        rows = 0
    with pytest.raises((TypeError, ValueError)):
        ss.segment_sum(ids, g, rows)


@pytest.mark.parametrize("num_rows,bits", [
    (1, 1), (2, 2),
    (4096, 13),           # a power of two: the sentinel 4096 needs bit 12
    (4097, 13),
    (840_704, 20),        # the Criteo tables at full width
    (2 ** 31 - 2, 31),    # the most rows the kernel takes
])
def test_sort_keys_cover_every_row_and_the_sentinel(num_rows, bits):
    """The sort runs over ``key_bits(num_rows)`` bits: enough for every key
    in ``0..num_rows`` (``num_rows`` is the sentinel of out-of-range ids)
    and no more."""
    assert ss.key_bits(num_rows) == bits
    assert num_rows < 2 ** bits and (num_rows - 1) < 2 ** bits
    assert num_rows >= 2 ** (bits - 1)


@pytest.mark.parametrize("n,rows", [(2 ** 31, 10), (10, 2 ** 31 - 1),
                                    (10, 2 ** 40)])
def test_segment_sum_rejects_what_32_bit_keys_cannot_hold(n, rows):
    """More than 2^31 - 1 ids, or a table whose sentinel row id would not
    fit a 31-bit key, is refused before any launch; the shapes are checked
    on ``meta`` tensors, which allocate nothing."""
    ids = torch.empty(n, dtype=torch.int64, device="meta")
    g = torch.empty(n, 1, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="32-bit keys"):
        ss.segment_sum(ids, g, rows)
