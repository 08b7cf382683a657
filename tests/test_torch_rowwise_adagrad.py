"""Row-wise Adagrad's update from a sparse gradient (``ops/rowwise_adagrad.py``)
against the dense row-wise Adagrad over every row of a dense gradient, and
the optimizer that uses it (``train/optim.py`` ``rowwise_adagrad``).

On the CPU the wrapper takes its plain version. The dense update is written
here, each row's accumulator a + mean(g²) and its row w − lr·g / (√a + ε):
a row no id touched has a zero gradient there, and the sparse update must
leave such a row and its accumulator bitwise as they were, and give every
touched row the dense update's bits (the same float32 operations in the
same order). The CUDA kernel runs only on a card: the ``gpu``-marked test
compares it with the plain version there.
"""

import pytest
import torch

from recsys_tpu_torch.ops import rowwise_adagrad as ra
from recsys_tpu_torch.ops import segment_sum as ss
from recsys_tpu_torch.train import optim

LR, EPS = 0.005, 1e-8


def _dense_rowwise(table, acc, dense_grad):
    """The dense update over every row."""
    a = acc + (dense_grad * dense_grad).mean(dim=1)
    return table - LR * dense_grad / (a.sqrt() + EPS)[:, None], a


def _problem(seed, v=500, n=700, w=8, steps_acc=True):
    gen = torch.Generator().manual_seed(seed)
    table = torch.randn(v, w, generator=gen)
    acc = (torch.rand(v, generator=gen) if steps_acc
           else torch.zeros(v))
    ids = torch.randint(0, v // 3, (n,), generator=gen)
    grads = torch.randn(n, w, generator=gen)
    return table, acc, ids, grads


def _sparse(ids, grads, num_rows):
    """The sparse gradient of one gradient row per id."""
    return ss.segment_sum_sparse(ids, grads, num_rows, torch.arange(
        ids.shape[0], dtype=torch.int32, device=ids.device))


@pytest.mark.parametrize("seed,fresh", [(0, True), (1, False), (2, True)])
def test_the_sparse_update_is_the_dense_one_row_for_row(seed, fresh):
    table, acc, ids, grads = _problem(seed, steps_acc=not fresh)
    sparse = _sparse(ids, grads, table.shape[0])
    dense_grad = ss.segment_sum(ids, grads, table.shape[0])
    want_t, want_a = _dense_rowwise(table, acc, dense_grad)
    t, a = table.clone(), acc.clone()
    ra.rowwise_adagrad(t, a, sparse, LR, EPS)
    assert torch.equal(t, want_t) and torch.equal(a, want_a)
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[ids] = False
    assert untouched.any()
    assert torch.equal(t[untouched], table[untouched])
    assert torch.equal(a[untouched], acc[untouched])


def test_places_past_the_count_are_not_read():
    """The rows past ``count`` (undefined on the card) and their sentinel
    ids change nothing."""
    table, acc, ids, grads = _problem(3)
    sparse = _sparse(ids, grads, table.shape[0])
    count = int(sparse.count)
    junk = sparse.rows.clone()
    junk[count:] = float("nan")
    t1, a1, t2, a2 = table.clone(), acc.clone(), table.clone(), acc.clone()
    ra.rowwise_adagrad(t1, a1, sparse, LR, EPS)
    ra.rowwise_adagrad(t2, a2, sparse._replace(rows=junk), LR, EPS)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)


def test_the_wrapper_refuses_bad_inputs():
    table, acc, ids, grads = _problem(4)
    sparse = _sparse(ids, grads, table.shape[0])
    with pytest.raises(ValueError, match="acc"):
        ra.rowwise_adagrad(table, acc[:-1], sparse, LR, EPS)
    with pytest.raises(TypeError, match="ids"):
        ra.rowwise_adagrad(table, acc, sparse._replace(
            ids=sparse.ids.int()), LR, EPS)
    with pytest.raises(ValueError, match="rows"):
        ra.rowwise_adagrad(table, acc, sparse._replace(
            rows=sparse.rows[:, :3]), LR, EPS)


def test_the_optimizer_updates_tables_row_wise_and_the_rest_elementwise():
    """``optim.rowwise_adagrad``: the named table by its touched rows, one
    accumulator a row; every other leaf elementwise, a ← a + g²,
    p ← p − lr·g / (√a + ε), over two steps."""
    table, _, ids, grads = _problem(5)
    gen = torch.Generator().manual_seed(6)
    params = {"table": table.clone(),
              "mlp": {"w": torch.randn(4, 3, generator=gen),
                      "b": torch.randn(3, generator=gen)}}
    tx = optim.rowwise_adagrad(LR, ("table",), eps=EPS)
    state = tx.init(params)
    assert state.acc["table"].shape == (table.shape[0],)
    assert state.acc["mlp"]["w"].shape == (4, 3)
    want = {"table": table.clone(),
            "w": params["mlp"]["w"].clone(), "b": params["mlp"]["b"].clone()}
    want_acc = {"table": torch.zeros(table.shape[0]),
                "w": torch.zeros(4, 3), "b": torch.zeros(3)}
    for step in range(2):
        g_w = torch.randn(4, 3, generator=gen)
        g_b = torch.randn(3, generator=gen)
        sparse = _sparse(ids, grads * (step + 1), table.shape[0])
        tx.update({"table": sparse, "mlp": {"w": g_w, "b": g_b}}, state,
                  params)
        dense = ss.segment_sum(ids, grads * (step + 1), table.shape[0])
        want["table"], want_acc["table"] = _dense_rowwise(
            want["table"], want_acc["table"], dense)
        for k, g in (("w", g_w), ("b", g_b)):
            want_acc[k] = want_acc[k] + g * g
            want[k] = want[k] - LR * g / (want_acc[k].sqrt() + EPS)
    torch.testing.assert_close(params["table"], want["table"], rtol=0,
                               atol=0)
    for k in ("w", "b"):
        torch.testing.assert_close(params["mlp"][k], want[k], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(state.acc["mlp"][k], want_acc[k],
                                   rtol=1e-6, atol=1e-7)


def test_the_optimizer_refuses_a_dense_gradient_for_a_table():
    table, _, _, _ = _problem(7)
    tx = optim.rowwise_adagrad(LR, ("table",))
    params = {"table": table}
    with pytest.raises(TypeError, match="sparse"):
        tx.update({"table": torch.zeros_like(table)}, tx.init(params),
                  params)


@pytest.mark.gpu
@pytest.mark.parametrize("w,n", [(128, 200_000), (8, 5000), (33, 1)])
def test_kernel_matches_plain_version(w, n):
    """On the card: the kernel against the plain version on the same sparse
    gradient: accumulators within 1e-6 relative (Σg² in another order,
    its squares fused into the adds), rows within 2e-6 relative (the
    accumulator's rounding through √), untouched rows bitwise unchanged,
    and two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(w + n)
    v = 3 * n + 10
    table = torch.randn(v, w, generator=gen).to(dev)
    acc = torch.rand(v, generator=gen).to(dev)
    ids = torch.randint(0, v, (n,), generator=gen).to(dev)
    sparse = _sparse(ids, torch.randn(n, w, generator=gen).to(dev), v)
    got_t, got_a = table.clone(), acc.clone()
    ra.rowwise_adagrad(got_t, got_a, sparse, LR, EPS)
    again_t, again_a = table.clone(), acc.clone()
    ra.rowwise_adagrad(again_t, again_a, sparse, LR, EPS)
    want_t, want_a = table.clone(), acc.clone()
    ra.rowwise_adagrad_reference(want_t, want_a, sparse, LR, EPS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_a, want_a, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=2e-6, atol=1e-7)
    assert torch.equal(got_t, again_t) and torch.equal(got_a, again_a)
    untouched = torch.ones(v, dtype=torch.bool, device=dev)
    untouched[ids] = False
    assert torch.equal(got_t[untouched], table[untouched])
    assert torch.equal(got_a[untouched], acc[untouched])
