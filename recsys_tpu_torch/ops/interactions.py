"""Interaction ops (counterpart of ``recsys_tpu/ops/interactions.py``):
the FM pairwise term from field sums, and CIN.

Shapes use B=batch, F=num fields, D=embedding dim, H=CIN feature maps.
DCN's cross layers and DIN's attention are not ported yet.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import cin_kernel, nn


def fm_pairwise_from_sums(emb_sum: torch.Tensor,
                          emb_sq_sum: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ_d [(Σ_f e_fd)² − Σ_f e_fd²] → [B, 1] from the [B, D] sums."""
    return 0.5 * (emb_sum.square() - emb_sq_sum).sum(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# CIN — compressed interaction network
# ---------------------------------------------------------------------------

def cin_init(gen: torch.Generator, num_fields: int,
             layer_sizes: tuple[int, ...], device,
             dtype=torch.float32) -> list[dict]:
    """Filters W_k [F_{k-1}·F_0, H_k] (glorot_uniform) + zero bias."""
    params = []
    fk = num_fields
    for h in layer_sizes:
        params.append({
            "w": nn.glorot_uniform(gen, (fk * num_fields, h), device, dtype),
            "b": torch.zeros((h,), dtype=dtype, device=device),
        })
        fk = h
    return params


def cin_apply(params, x0: torch.Tensor) -> torch.Tensor:
    """CIN forward → pooled concat [B, Σ_k H_k].

    Layout as in the JAX package: x0 [B, F0, D] becomes x0v =
    x0.transpose(0, 2, 1).reshape(B·D, F0); layer k forms
    z[(b,d), p·Fk+q] = x0v[(b,d), p] · xkv[(b,d), q] (x0 index outer),
    x_{k+1} = relu(z @ W_k + b_k); every layer's output is sum-pooled over
    D and the pools are concatenated (direct connect). Each layer runs
    through `cin_kernel.cin_layer`: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    return cin_kernel.cin_apply_fused(params, x0)
