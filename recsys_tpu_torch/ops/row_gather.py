"""Row gather: the forward of an embedding-table read — the CUDA kernel's
wrapper and its plain version (counterpart of the TPU prototype
``scratch/rowdma_kernel.py`` ``rowdma_gather``, the per-row-DMA gather).

    row_gather(table [V, W] float32, ids [N] int64) -> [N, W] float32
    out[i] = table[ids[i]]

For CUDA tensors the rows are copied by the hand-written kernel
``csrc/row_gather.cu`` (whose header says what bounds it on the H100 and
how its design answers). A copy is exact, so the result is bitwise equal to
``torch.index_select``. On the card an id outside ``[0, V)`` reads nothing
and gives a row of zeros; callers keep such ids away (the servables reject
them on the host). For CPU tensors the wrapper takes the plain version,
``torch.index_select``, which raises on such an id.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import I, LL, P

#: a launch counts under ``row_gather`` (`cuda_build.launches`)
SOURCE = cuda_build.source("row_gather.cu",
                           row_gather=[P, P, P, LL, I, LL, P])


def row_gather_reference(table: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.index_select`` along the rows."""
    return torch.index_select(table, 0, ids)


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"row_gather: want table [V, W] and ids [N], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"row_gather: table is {table.dtype}, want float32")
    if ids.dtype != torch.int64:
        raise TypeError(f"row_gather: ids are {ids.dtype}, want int64")
    if not table.is_contiguous() or not ids.is_contiguous():
        raise ValueError("row_gather: table and ids must be contiguous")
    if ids.device != table.device:
        raise ValueError(f"row_gather: ids on {ids.device}, table on "
                         f"{table.device}")
    if table.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError(f"row_gather: empty table {tuple(table.shape)}")


def row_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` → ``[N, W]`` float32.

    CUDA tensors go through the kernel; the call raises if it cannot
    launch. CPU tensors go through `row_gather_reference`."""
    _check(table, ids)
    if table.device.type == "cpu":
        return row_gather_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather: no kernel for device {table.device}")
    n, w = ids.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    cuda_build.launch(SOURCE, "row_gather", table.device, table.data_ptr(),
                      ids.data_ptr(), out.data_ptr(), n, w, table.shape[0])
    return out
