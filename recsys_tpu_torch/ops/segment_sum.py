"""Segment sum: the dense gradient of a table's row gather — the CUDA
kernel's wrapper and its plain version (counterpart of the embedding-gradient
scatters in ``recsys_tpu/ops/pallas_kernels.py``: ``embedding_grad_T`` and
``embedding_grad``).

    segment_sum(ids [N], grads [N, W], num_rows) -> [num_rows, W] float32
    out[v] = Σ_{i: ids[i] = v} grads[i]

For CUDA tensors the whole sum is one call into ``csrc/segment_sum.cu``
(whose header says what bounds it on the H100 and how its design answers):
it zeroes the output, turns the ids into 32-bit keys, sorts them stably over
only the bits a row id can have (`key_bits`), and sums each row's run with
the hand-written kernels. The wrapper allocates the output and one
workspace with ``torch.empty`` (the workspace's size is asked of the C side
once per shape) and launches nothing else, so the call can be captured in a
CUDA graph. Every touched row is written once, without atomics, so two
calls give bitwise-equal results; untouched rows are zero, and an id
outside ``[0, num_rows)`` adds nothing. For CPU tensors the wrapper takes
the plain version, ``index_add_`` into zeros (which raises on such an id).

The sparse mode gives the same sums without the dense table, for a table
far larger than a step's ids (DLRM's):

    segment_sum_sparse(ids [N], grads [M, W], num_rows, grad_rows [N])
        -> SparseRows(ids [N] int64, rows [N, W] float32, count [] int64)

the distinct ids in ``[0, num_rows)`` in ascending order, then
``num_rows`` at every place from the count on; each distinct id's summed
row at its place; and their count, a device scalar that is never read back,
so the call captures into a CUDA graph. ``grad_rows`` (int32 [N]) names
each id's row of ``grads``: a bag pooled into one row hands that row's
gradient to each of its ids, and the kernel reads it in place of a
broadcast copy. On the card it is one call into the same
source (its sort and sums, and a scan that numbers the distinct ids); the
rows past the count are not written there. Each distinct row is summed in
the ids' order, as the dense mode sums it, so the two give the same bits.
The plain version (CPU) is ``torch.unique`` and ``index_add_``, the rows
past the count zero.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import I, LL, P

#: a launch with ids counts under ``segment_sum`` (`cuda_build.launches`)
SOURCE = cuda_build.source(
    "segment_sum.cu",
    segment_sum=[P, P, P, P, ctypes.c_ulonglong, LL, I, LL, I, P],
    segment_sum_workspace_bytes=[LL, I, I,
                                 ctypes.POINTER(ctypes.c_ulonglong)],
    segment_sum_sparse=[P, P, P, P, P, P, P, ctypes.c_ulonglong, LL, I, LL,
                        I, P],
    segment_sum_sparse_workspace_bytes=[LL, I, I,
                                        ctypes.POINTER(ctypes.c_ulonglong)])
#: The kernel's int32 limits: at most MAX_IDS ids, at most MAX_ROWS rows
#: (the out-of-range sentinel is ``num_rows`` itself).
MAX_IDS = 2 ** 31 - 1
MAX_ROWS = 2 ** 31 - 2

#: workspace bytes by (entry point, n, w, end_bit)
_workspace: dict[tuple[str, int, int, int], int] = {}


class SparseRows(NamedTuple):
    """A table's gradient on the rows a step touched (`segment_sum_sparse`):
    the first ``count`` places of ``ids`` and ``rows`` hold the distinct
    rows, ascending, and their summed gradients."""

    ids: torch.Tensor     # [N] int64; the table's row count past ``count``
    rows: torch.Tensor    # [N, W] float32
    count: torch.Tensor   # [] int64, on the device


def key_bits(num_rows: int) -> int:
    """Bits the sort keys need for a table of ``num_rows`` rows: keys run
    over ``0..num_rows``, the last one the sentinel of ids out of range."""
    return int(num_rows).bit_length()


def segment_sum_reference(ids: torch.Tensor, grads: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """The plain version: ``index_add_`` into a zero table."""
    out = torch.zeros((num_rows, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids, grads.float())


def _check(ids: torch.Tensor, grads: torch.Tensor, num_rows: int) -> None:
    if ids.dim() != 1 or grads.dim() != 2 or ids.shape[0] != grads.shape[0]:
        raise ValueError(f"segment_sum: want ids [N] and grads [N, W], got "
                         f"{tuple(ids.shape)} and {tuple(grads.shape)}")
    if ids.dtype != torch.int64:
        raise TypeError(f"segment_sum: ids are {ids.dtype}, want int64")
    if grads.dtype != torch.float32:
        raise TypeError(f"segment_sum: grads are {grads.dtype}, want float32")
    if not grads.is_contiguous() or not ids.is_contiguous():
        raise ValueError("segment_sum: ids and grads must be contiguous")
    if ids.device != grads.device:
        raise ValueError(f"segment_sum: ids on {ids.device}, grads on "
                         f"{grads.device}")
    if num_rows <= 0 or grads.shape[1] == 0:
        raise ValueError(f"segment_sum: {num_rows} rows of width "
                         f"{grads.shape[1]}")
    if ids.shape[0] > MAX_IDS or num_rows > MAX_ROWS:
        raise ValueError(f"segment_sum: {ids.shape[0]} ids into {num_rows} "
                         f"rows; the kernel takes at most {MAX_IDS} ids and "
                         f"{MAX_ROWS} rows (32-bit keys and positions)")


def _workspace_bytes(n: int, w: int, end_bit: int,
                     entry: str = "segment_sum_workspace_bytes") -> int:
    key = (entry, n, w, end_bit)
    size = _workspace.get(key)
    if size is None:
        lib = cuda_build.load(SOURCE)
        out = ctypes.c_ulonglong()
        err = getattr(lib, entry)(n, w, end_bit, ctypes.byref(out))
        cuda_build.check(lib, err, entry)
        size = _workspace[key] = out.value
    return size


def segment_sum(ids: torch.Tensor, grads: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Σ of ``grads`` rows per id → ``[num_rows, W]`` float32.

    CUDA tensors go through the kernel; the call raises if it cannot launch.
    CPU tensors go through `segment_sum_reference`. On the card an id
    outside ``[0, num_rows)`` adds nothing; callers keep such ids away."""
    _check(ids, grads, num_rows)
    if ids.device.type == "cpu":
        return segment_sum_reference(ids, grads, num_rows)
    if ids.device.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for device {ids.device}")
    n, w = grads.shape
    end_bit = key_bits(num_rows)
    out = torch.empty((num_rows, w), dtype=torch.float32, device=ids.device)
    ws = torch.empty((_workspace_bytes(n, w, end_bit),), dtype=torch.uint8,
                     device=ids.device)
    # N = 0 zeroes the output, and counts as no launch of the sum
    cuda_build.launch(SOURCE, "segment_sum", ids.device, ids.data_ptr(),
                      grads.data_ptr(), out.data_ptr(), ws.data_ptr(),
                      ws.numel(), n, w, num_rows, end_bit, n=1 if n else 0)
    return out


def _check_sparse(ids: torch.Tensor, grads: torch.Tensor, num_rows: int,
                  grad_rows: torch.Tensor) -> None:
    if grads.dim() != 2 or not grads.is_contiguous() \
            or grads.dtype != torch.float32 or grads.device != ids.device:
        raise ValueError(f"segment_sum_sparse: want contiguous float32 grads "
                         f"[M, W] on {ids.device}, got {grads.dtype} "
                         f"{tuple(grads.shape)} on {grads.device}")
    _check(ids, grads.new_empty((ids.shape[0], grads.shape[1])), num_rows)
    if (grad_rows.shape != ids.shape or grad_rows.dtype != torch.int32
            or not grad_rows.is_contiguous()
            or grad_rows.device != ids.device):
        raise ValueError(f"segment_sum_sparse: want contiguous int32 "
                         f"grad_rows [{ids.shape[0]}] on {ids.device}, got "
                         f"{grad_rows.dtype} {tuple(grad_rows.shape)} on "
                         f"{grad_rows.device}")


def segment_sum_sparse_reference(ids: torch.Tensor, grads: torch.Tensor,
                                 num_rows: int, grad_rows: torch.Tensor
                                 ) -> SparseRows:
    """The plain version of the sparse mode: ``torch.unique`` of the ids in
    range and ``index_add_`` of their gradient rows, in the ids' order,
    into zeros."""
    n = ids.shape[0]
    src = grads[grad_rows.long()]
    keep = (ids >= 0) & (ids < num_rows)
    distinct, inverse = torch.unique(ids[keep], sorted=True,
                                     return_inverse=True)
    count = distinct.shape[0]
    out_ids = torch.full((n,), num_rows, dtype=torch.int64,
                         device=ids.device)
    out_ids[:count] = distinct
    rows = torch.zeros((n, grads.shape[1]), dtype=torch.float32,
                       device=grads.device)
    rows.index_add_(0, inverse, src[keep].float())
    return SparseRows(out_ids, rows, torch.tensor(count, dtype=torch.int64,
                                                  device=ids.device))


def segment_sum_sparse(ids: torch.Tensor, grads: torch.Tensor, num_rows: int,
                       grad_rows: torch.Tensor) -> SparseRows:
    """The summed gradient of each distinct id → `SparseRows`, never a
    buffer of ``num_rows`` rows. ``grads`` is [M, W] float32, and id i
    takes its row ``grad_rows[i]`` (int32 [N], each in ``[0, M)``).

    CUDA tensors go through the kernel (one launch counted under
    ``segment_sum``); the call raises if it cannot launch. CPU tensors go
    through `segment_sum_sparse_reference`. An id outside
    ``[0, num_rows)`` adds nothing."""
    _check_sparse(ids, grads, num_rows, grad_rows)
    if ids.device.type == "cpu":
        return segment_sum_sparse_reference(ids, grads, num_rows, grad_rows)
    if ids.device.type != "cuda":
        raise ValueError(f"segment_sum_sparse: no kernel for device "
                         f"{ids.device}")
    n, w = ids.shape[0], grads.shape[1]
    end_bit = key_bits(num_rows)
    out = SparseRows(
        torch.empty((n,), dtype=torch.int64, device=ids.device),
        torch.empty((n, w), dtype=torch.float32, device=ids.device),
        torch.empty((), dtype=torch.int64, device=ids.device))
    ws = torch.empty((_workspace_bytes(
        n, w, end_bit, "segment_sum_sparse_workspace_bytes"),),
        dtype=torch.uint8, device=ids.device)
    cuda_build.launch(SOURCE, "segment_sum_sparse", ids.device,
                      ids.data_ptr(), grads.data_ptr(), grad_rows.data_ptr(),
                      out.ids.data_ptr(), out.rows.data_ptr(),
                      out.count.data_ptr(), ws.data_ptr(), ws.numel(), n, w,
                      num_rows, end_bit, counter="segment_sum",
                      n=1 if n else 0)
    return out
