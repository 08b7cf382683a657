"""Reshape probes: ``2·x`` over a float32 table read flat or in 2-D — the
CUDA kernel's wrappers and their plain versions (counterparts of
``scratch/mosaic_reshape_test.py``'s ``via_reshape`` and ``via_2d``).

    via_reshape(flat [VP·W], width W) -> [VP, W] float32    (S2)
    via_2d(x [VP, W]) -> [VP, W] float32                     (S3)
    out = 2 · x

The TPU functions are compiler probes: they asked whether Mosaic could
reshape a flat block into a ``[512, 17]`` tile. No path of either package
reaches them; they are ported so that every TPU kernel of the repository
has a counterpart, and ``chip_smoke.py`` measures them. For CUDA tensors
both go through the hand-written kernel ``csrc/reshape_probe.cu`` (whose
header says what bounds it on the H100 and how its design answers); the
result is exact, so bitwise equal to the plain version. For CPU tensors the
wrappers take the plain version, ``2.0 * x.reshape(VP, W)``.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import I, LL, P

#: launches count under ``via_reshape`` and ``via_2d``
#: (`cuda_build.launches`)
SOURCE = cuda_build.source("reshape_probe.cu", via_reshape=[P, P, LL, I, P],
                           via_2d=[P, P, LL, I, P])


def reshape_probe_reference(x: torch.Tensor, width: int) -> torch.Tensor:
    """The plain version of both probes: ``2.0 * x.reshape(VP, W)``."""
    return 2.0 * x.reshape(-1, width)


def _check(x: torch.Tensor, width: int, what: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: input is {x.dtype}, want float32")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input is not contiguous")
    if width <= 0 or x.numel() == 0 or x.numel() % width:
        raise ValueError(f"{what}: {x.numel()} elements do not make rows "
                         f"of width {width}")


def _launch(entry: str, x: torch.Tensor, width: int) -> torch.Tensor:
    rows = x.numel() // width
    out = torch.empty((rows, width), dtype=torch.float32, device=x.device)
    cuda_build.launch(SOURCE, entry, x.device, x.data_ptr(), out.data_ptr(),
                      rows, width)
    return out


def via_reshape(flat: torch.Tensor, width: int) -> torch.Tensor:
    """``2 · flat.reshape(VP, width)`` → ``[VP, width]`` float32 (S2).

    CUDA tensors go through the kernel; the call raises if it cannot
    launch. CPU tensors go through `reshape_probe_reference`."""
    if flat.dim() != 1:
        raise ValueError(f"via_reshape: want flat [VP·W], got "
                         f"{tuple(flat.shape)}")
    _check(flat, width, "via_reshape")
    if flat.device.type == "cpu":
        return reshape_probe_reference(flat, width)
    if flat.device.type != "cuda":
        raise ValueError(f"via_reshape: no kernel for device {flat.device}")
    return _launch("via_reshape", flat, width)


def via_2d(x: torch.Tensor) -> torch.Tensor:
    """``2 · x`` → ``[VP, W]`` float32 (S3).

    CUDA tensors go through the kernel; the call raises if it cannot
    launch. CPU tensors go through `reshape_probe_reference`."""
    if x.dim() != 2:
        raise ValueError(f"via_2d: want x [VP, W], got {tuple(x.shape)}")
    _check(x, x.shape[1], "via_2d")
    if x.device.type == "cpu":
        return reshape_probe_reference(x, x.shape[1])
    if x.device.type != "cuda":
        raise ValueError(f"via_2d: no kernel for device {x.device}")
    return _launch("via_2d", x, x.shape[1])
