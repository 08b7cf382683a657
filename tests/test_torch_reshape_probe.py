"""The counterparts of the TPU reshape probes S2 and S3
(``scratch/mosaic_reshape_test.py`` ``via_reshape`` and ``via_2d``), on the
CPU, where the wrappers take their plain version.

The JAX probes cannot be called here: ``scratch/mosaic_reshape_test.py``
builds its full-size input and runs its TPU benchmark when it is imported.
What they compute is ``2 · flat.reshape(VP, 17)``, so the plain versions
are held bitwise against numpy's ``2 · flat.reshape(VP, W)`` (doubling a
float rounds nothing). The kernel is held against them on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops import reshape_probe as rp

W = 17


@pytest.mark.parametrize("vp", [1, 1001, 512 * 3])
def test_plain_versions_are_numpy_bitwise(vp):
    flat = np.random.default_rng(vp).standard_normal(vp * W).astype(
        np.float32)
    want = 2 * flat.reshape(vp, W)
    with cuda_build.counting() as launches:
        got_flat = rp.via_reshape(torch.from_numpy(flat), W)
        got_2d = rp.via_2d(torch.from_numpy(flat.reshape(vp, W)))
    for got in (got_flat, got_2d,
                rp.reshape_probe_reference(torch.from_numpy(flat), W)):
        assert got.shape == (vp, W) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors take the plain version: no kernel launch is counted
    assert (launches["via_reshape"], launches["via_2d"]) == (0, 0)


@pytest.mark.parametrize("case", ["ragged", "float64", "2d_flat", "1d_2d",
                                  "strided"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    x = torch.randn(10 * W)
    with pytest.raises((ValueError, TypeError)):
        if case == "ragged":
            rp.via_reshape(x[:-1], W)
        elif case == "float64":
            rp.via_reshape(x.double(), W)
        elif case == "2d_flat":
            rp.via_reshape(x.view(10, W), W)
        elif case == "1d_2d":
            rp.via_2d(x)
        else:
            rp.via_2d(x.view(10, W)[:, :5])
