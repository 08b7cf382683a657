"""Row-wise Adagrad's update of a table from its sparse gradient, in place —
the CUDA kernel's wrapper and its plain version. The kernel replaces no TPU
kernel (the JAX package trains every table with dense Adam);
``csrc/rowwise_adagrad.cu`` says why it was added, what bounds it on the
H100 and how its design answers.

    rowwise_adagrad(table [V, W], acc [V], grad: SparseRows, lr, eps)

    for i below grad.count, r = grad.ids[i], g = grad.rows[i]:
        acc[r] ← acc[r] + mean(g²)
        table[r] ← table[r] − lr·g / (√acc[r] + ε)

One accumulator a row (the row-wise Adagrad of DLRM's embedding tables).
The gradient's ids are distinct (`segment_sum.segment_sum_sparse`), so each
row is updated once. A row that no id touched would have a zero gradient,
under which the update leaves the row and its accumulator exactly as they
were: this update over the touched rows equals the dense update over every
row, row for row.

For CUDA tensors it is one launch of the kernel, which reads the count on
the card, so a step that uses it captures into one CUDA graph. For CPU
tensors the wrapper takes the plain version, `rowwise_adagrad_reference`.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import F, I, LL, P
from recsys_tpu_torch.ops.segment_sum import SparseRows

#: a launch counts under ``rowwise_adagrad`` (`cuda_build.launches`)
SOURCE = cuda_build.source("rowwise_adagrad.cu",
                           rowwise_adagrad=[P, P, P, P, P, LL, I, LL, F, F,
                                            P])


@torch.no_grad()
def rowwise_adagrad_reference(table: torch.Tensor, acc: torch.Tensor,
                              grad: SparseRows, lr: float,
                              eps: float) -> None:
    """The plain version, on the touched rows: PyTorch's operations in the
    kernel's order."""
    count = int(grad.count)
    ids, g = grad.ids[:count], grad.rows[:count]
    a = acc[ids] + (g * g).mean(dim=1)
    acc[ids] = a
    table[ids] = table[ids] - lr * g / (a.sqrt() + eps)[:, None]


def _check(table: torch.Tensor, acc: torch.Tensor, grad: SparseRows) -> None:
    if table.dim() != 2 or acc.shape != table.shape[:1]:
        raise ValueError(f"rowwise_adagrad: want table [V, W] and acc [V], "
                         f"got {tuple(table.shape)} and {tuple(acc.shape)}")
    n = grad.ids.shape[0]
    if grad.ids.shape != (n,) or grad.rows.shape != (n, table.shape[1]) \
            or grad.count.shape != ():
        raise ValueError(f"rowwise_adagrad: want ids [N], rows [N, "
                         f"{table.shape[1]}] and a scalar count, got "
                         f"{tuple(grad.ids.shape)}, {tuple(grad.rows.shape)}"
                         f" and {tuple(grad.count.shape)}")
    for name, t, dtype in (("table", table, torch.float32),
                           ("acc", acc, torch.float32),
                           ("ids", grad.ids, torch.int64),
                           ("rows", grad.rows, torch.float32),
                           ("count", grad.count, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"rowwise_adagrad: {name} is {t.dtype}, want "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rowwise_adagrad: {name} is not contiguous")
        if t.device != table.device:
            raise ValueError(f"rowwise_adagrad: {name} on {t.device}, the "
                             f"table on {table.device}")


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, grad: SparseRows,
                    lr: float, eps: float) -> None:
    """One row-wise Adagrad step of ``table`` and its per-row accumulator
    ``acc`` from ``grad``, written into both.

    CUDA tensors go through the kernel; the call raises if it cannot
    launch. CPU tensors go through `rowwise_adagrad_reference`."""
    _check(table, acc, grad)
    if table.device.type == "cpu":
        rowwise_adagrad_reference(table, acc, grad, lr, eps)
        return
    if table.device.type != "cuda":
        raise ValueError(f"rowwise_adagrad: no kernel for device "
                         f"{table.device}")
    n, w = grad.rows.shape
    cuda_build.launch(SOURCE, "rowwise_adagrad", table.device,
                      table.data_ptr(), acc.data_ptr(), grad.ids.data_ptr(),
                      grad.rows.data_ptr(), grad.count.data_ptr(), n, w,
                      table.shape[0], lr, eps, n=1 if n else 0)
