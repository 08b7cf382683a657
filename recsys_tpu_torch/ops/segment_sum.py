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
"""

from __future__ import annotations

import ctypes

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import I, LL, P

#: a launch with ids counts under ``segment_sum`` (`cuda_build.launches`)
SOURCE = cuda_build.source(
    "segment_sum.cu",
    segment_sum=[P, P, P, P, ctypes.c_ulonglong, LL, I, LL, I, P],
    segment_sum_workspace_bytes=[LL, I, I,
                                 ctypes.POINTER(ctypes.c_ulonglong)])
#: The kernel's int32 limits: at most MAX_IDS ids, at most MAX_ROWS rows
#: (the out-of-range sentinel is ``num_rows`` itself).
MAX_IDS = 2 ** 31 - 1
MAX_ROWS = 2 ** 31 - 2

#: workspace bytes by (n, w, end_bit)
_workspace: dict[tuple[int, int, int], int] = {}


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


def _workspace_bytes(n: int, w: int, end_bit: int) -> int:
    key = (n, w, end_bit)
    size = _workspace.get(key)
    if size is None:
        lib = cuda_build.load(SOURCE)
        out = ctypes.c_ulonglong()
        err = lib.segment_sum_workspace_bytes(n, w, end_bit,
                                              ctypes.byref(out))
        cuda_build.check(lib, err, "segment_sum_workspace_bytes")
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
