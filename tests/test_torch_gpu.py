"""The port on the card: the CUDA CIN kernel against its plain version at
the shapes of full-width xDeepFM, and a servable on the card against the
same servable on the CPU. Every test here is marked ``gpu`` and skips
without a CUDA device (the kernel has no CPU mode). This file imports
neither jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance 1e-4 absolute and relative: float32 sums of up to 1521 terms,
taken in another order than cuBLAS takes them.
"""

import numpy as np
import pytest
import torch

from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data.criteo import synthetic_criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.ops import cin_kernel
from recsys_tpu_torch.serve.export import Servable, export_servable

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [16, 3333, 16 * 4096])
@pytest.mark.parametrize("fk,h", [(39, 20), (20, 10), (10, 10)])
def test_kernel_matches_plain_version(cuda_device, n, fk, h):
    gen = torch.Generator().manual_seed(n + fk)
    x0v = torch.randn(n, 39, generator=gen).to(cuda_device)
    xkv = torch.randn(n, fk, generator=gen).to(cuda_device)
    w = (0.05 * torch.randn(39 * fk, h, generator=gen)).to(cuda_device)
    b = torch.randn(h, generator=gen).to(cuda_device)
    before = cin_kernel.LAUNCHES
    got = cin_kernel.cin_layer(x0v, xkv, w, b)
    torch.cuda.synchronize()
    assert cin_kernel.LAUNCHES == before + 1
    torch.testing.assert_close(
        got, cin_kernel.cin_layer_reference(x0v, xkv, w, b),
        rtol=1e-4, atol=1e-4)


def test_kernel_refuses_bad_inputs_on_the_card(cuda_device):
    x0v = torch.randn(32, 39, device=cuda_device)
    w, b = torch.randn(39 * 39, 20, device=cuda_device), torch.zeros(20)
    with pytest.raises(ValueError, match="is on"):
        cin_kernel.cin_layer(x0v, x0v, w, b)               # b on the CPU
    with pytest.raises(TypeError):
        cin_kernel.cin_layer(x0v.half(), x0v.half(), w, b.to(cuda_device))


def test_servable_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    ccfg = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)
    mcfg = ModelConfig(name="xdeepfm", cin_layers=(20, 10, 10))
    params, state = make_model("xdeepfm", ccfg, mcfg).init(
        torch.Generator().manual_seed(0), "cpu")
    export_servable(str(tmp_path), "xdeepfm", params, state, mcfg, ccfg)
    d = synthetic_criteo(300, ccfg)
    feats = {"ids": d["ids"], "dense": d["dense"]}
    before = cin_kernel.LAUNCHES
    got = Servable(str(tmp_path), device="cuda").predict(feats)
    assert cin_kernel.LAUNCHES == before + 3
    ref = Servable(str(tmp_path), device="cpu").predict(feats)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
