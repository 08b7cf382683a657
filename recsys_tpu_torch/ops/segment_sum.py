"""Segment sum: the dense gradient of a table's row gather — the CUDA
kernel's wrapper and its plain version (counterpart of the embedding-gradient
scatters in ``recsys_tpu/ops/pallas_kernels.py``: ``embedding_grad_T`` and
``embedding_grad``).

    segment_sum(ids [N], grads [N, W], num_rows) -> [num_rows, W] float32
    out[v] = Σ_{i: ids[i] = v} grads[i]

For CUDA tensors the flat ids are sorted with ``torch.sort(stable=True)``
(outside the kernel, as ``embedding_grad_T`` sorts outside its Pallas body)
and the per-row sum is the hand-written kernel ``csrc/segment_sum.cu``
(whose header says what bounds it on the H100 and how its design answers).
It writes every touched row once, without atomics, so two calls give
bitwise-equal results; untouched rows are zero. For CPU tensors the wrapper
takes the plain version, ``index_add_`` into zeros.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from recsys_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source("segment_sum.cu")
CHUNK = 128   # sorted entries per warp (csrc/segment_sum.cu)

#: Kernel launches made by `segment_sum` (a plain count; read it to show that
#: a run went through the kernel, reset it by assigning 0).
LAUNCHES = 0
_count_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if lib.segment_sum_sorted.argtypes is None:
        lib.segment_sum_sorted.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_void_p])
        lib.segment_sum_sorted.restype = ctypes.c_int
    return lib


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
    if not grads.is_contiguous():
        raise ValueError("segment_sum: grads are not contiguous")
    if ids.device != grads.device:
        raise ValueError(f"segment_sum: ids on {ids.device}, grads on "
                         f"{grads.device}")
    if num_rows <= 0 or grads.shape[1] == 0:
        raise ValueError(f"segment_sum: {num_rows} rows of width "
                         f"{grads.shape[1]}")


def segment_sum(ids: torch.Tensor, grads: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Σ of ``grads`` rows per id → ``[num_rows, W]`` float32.

    CUDA tensors go through the kernel; the call raises if it cannot launch.
    CPU tensors go through `segment_sum_reference`. Ids must lie in
    ``[0, num_rows)``; the kernel writes no row outside the table."""
    global LAUNCHES
    _check(ids, grads, num_rows)
    if ids.device.type == "cpu":
        return segment_sum_reference(ids, grads, num_rows)
    if ids.device.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for device {ids.device}")
    n, w = grads.shape
    out = torch.zeros((num_rows, w), dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    sid, order = torch.sort(ids, stable=True)
    n_chunks = -(-n // CHUNK)
    head = torch.empty((n_chunks, w), dtype=torch.float32, device=ids.device)
    tail = torch.empty_like(head)
    lib = _lib()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.segment_sum_sorted(
            sid.data_ptr(), order.data_ptr(), grads.data_ptr(),
            out.data_ptr(), head.data_ptr(), tail.data_ptr(), n, w, num_rows,
            stream)
    cuda_build.check(lib, err, "segment_sum_sorted")
    with _count_lock:
        LAUNCHES += 1
    return out
