"""The port's segment sum (the embedding-gradient scatter) against the JAX
package's Pallas kernels, on the same numpy ids and gradients.

On the CPU the port's `segment_sum` takes its plain version; the JAX side
runs ``embedding_grad_T`` (K1, W-major output, transposed back here) and
``embedding_grad`` (K2, row-major) in interpret mode, as
tests/test_pallas_kernels.py runs them. Tolerance 1e-5 absolute and
relative, as there: float32 sums of the same terms in another order (the
Pallas kernels sum by one-hot matmuls).

The sparse mode's plain version (`segment_sum_sparse` on the CPU) against
the dense sum: the distinct ids ascending, then the sentinel; each one's
summed row exactly the dense row (the same adds in the same order); an
empty batch, all-duplicate ids, ids out of range and a bag map (each id
taking a pooled row) included.

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


def _identity(ids):
    """The map that gives id i gradient row i."""
    return torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)


def _sparse_against_dense(ids, g, v, grad_rows=None):
    if grad_rows is None:
        grad_rows = _identity(ids)
    got = ss.segment_sum_sparse(ids, g, v, grad_rows)
    src = g[grad_rows.long()]
    keep = (ids >= 0) & (ids < v)
    dense = ss.segment_sum_reference(ids[keep], src[keep], v)
    count = int(got.count)
    n = ids.shape[0]
    assert got.ids.shape == (n,) and got.rows.shape == (n, g.shape[1])
    assert torch.equal(got.ids[:count], torch.unique(ids[keep]))
    assert bool((got.ids[count:] == v).all())
    assert torch.equal(got.rows[:count], dense[got.ids[:count]])
    return got


@pytest.mark.parametrize("n,w,v", [
    (1000, 17, 2048),      # ragged, duplicates
    (64, 128, 100_000),    # N << V: every id distinct, DLRM's width
    (4096, 8, 16),         # N >> V: long runs
    (1, 3, 5),
])
def test_sparse_mode_gives_the_dense_rows_of_the_distinct_ids(n, w, v):
    gen = torch.Generator().manual_seed(n + w)
    ids = (v * torch.rand(n, generator=gen) ** 2.2).long().clamp_(max=v - 1)
    _sparse_against_dense(ids, torch.randn(n, w, generator=gen), v)


def test_sparse_mode_of_an_empty_batch_and_of_one_repeated_id():
    empty = _sparse_against_dense(torch.zeros(0, dtype=torch.int64),
                                  torch.zeros(0, 4), 10)
    assert int(empty.count) == 0
    same = _sparse_against_dense(torch.full((500,), 7), torch.randn(500, 4),
                                 10)
    assert int(same.count) == 1 and int(same.ids[0]) == 7
    assert bool((same.ids[1:] == 10).all())


def test_sparse_mode_drops_ids_out_of_range():
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(-20, 120, (800,), generator=gen)
    got = _sparse_against_dense(ids, torch.randn(800, 5, generator=gen), 100)
    assert int(got.count) == int(torch.unique(ids[(ids >= 0)
                                                  & (ids < 100)]).numel())


def test_sparse_mode_with_a_bag_map_equals_the_broadcast_gradient():
    """Each id of a bag takes its pooled row's gradient: with the map the
    sums are those of the broadcast rows, bitwise."""
    gen = torch.Generator().manual_seed(4)
    b, bags = 50, (3, 1, 5, 2)
    field = torch.repeat_interleave(torch.arange(4), torch.tensor(bags))
    rows = (torch.arange(b)[:, None] * 4 + field[None, :]).reshape(-1)
    ids = torch.randint(0, 40, (b * sum(bags),), generator=gen)
    pooled = torch.randn(b * 4, 8, generator=gen)
    mapped = _sparse_against_dense(ids, pooled, 40, rows.to(torch.int32))
    broadcast = ss.segment_sum_sparse(ids, pooled[rows], 40, _identity(ids))
    assert torch.equal(mapped.ids, broadcast.ids)
    assert torch.equal(mapped.rows, broadcast.rows)


@pytest.mark.parametrize("bad", ["map_dtype", "map_shape", "grads_dtype"])
def test_sparse_mode_rejects_what_the_kernel_does_not_take(bad):
    ids, g = torch.tensor([0, 1, 1]), torch.ones(2, 4)
    rows = torch.tensor([0, 1, 1], dtype=torch.int32)
    if bad == "map_dtype":
        rows = rows.long()
    elif bad == "map_shape":
        rows = rows[:2]
    else:
        g = g.double()
    with pytest.raises((TypeError, ValueError)):
        ss.segment_sum_sparse(ids, g, 2, rows)
