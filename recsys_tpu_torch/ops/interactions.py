"""Interaction ops (counterpart of ``recsys_tpu/ops/interactions.py``):
the FM pairwise term from field sums, DCN's cross layers, CIN, and DIN's
target attention.

Shapes use B=batch, F=num fields, D=embedding dim, H=CIN feature maps,
P=padded history length, K=DIN embedding dim.
"""

from __future__ import annotations

import torch

from recsys_tpu_torch.ops import cin_kernel, nn
from recsys_tpu_torch.ops import din_attention as din_attention_op
from recsys_tpu_torch.utils import profiling


def fm_pairwise_from_sums(emb_sum: torch.Tensor,
                          emb_sq_sum: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ_d [(Σ_f e_fd)² − Σ_f e_fd²] → [B, 1] from the [B, D] sums."""
    return 0.5 * (emb_sum.square() - emb_sq_sum).sum(dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# DCN cross layers (dcn/dcn.py:132-142)
# ---------------------------------------------------------------------------

def cross_init(gen: torch.Generator, dim: int, num_layers: int, device,
               dtype=torch.float32) -> list[dict]:
    """Per layer a rank-1 weight ``w`` and a bias ``b``, both [dim] and both
    glorot_normal, as in the reference (the bias too)."""
    return [{"w": nn.glorot_normal(gen, (dim,), device, dtype),
             "b": nn.glorot_normal(gen, (dim,), device, dtype)}
            for _ in range(num_layers)]


def cross_apply(params, x0: torch.Tensor) -> torch.Tensor:
    """x_{l+1} = x0 · (x_l ⊤ w_l) + x_l + b_l over [B, dim]: plain PyTorch,
    as the JAX package leaves it to XLA."""
    xl = x0
    for layer in params:
        xw = xl @ layer["w"]                                  # [B]
        xl = xw[:, None] * x0 + xl + layer["b"]
    return xl


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


# ---------------------------------------------------------------------------
# DIN target attention (din/din.py:103-125)
# ---------------------------------------------------------------------------

def din_attention_init(gen: torch.Generator, emb_dim: int,
                       attention_layers: tuple[int, ...], device,
                       dtype=torch.float32) -> dict:
    """{'mlp': [dense per hidden layer], 'out': dense → 1}; the MLP's input
    is the 4K-wide [hist, query, hist⊙query, hist−query]."""
    params: dict = {"mlp": []}
    d = 4 * emb_dim
    for h in attention_layers:
        params["mlp"].append(nn.dense_init(gen, d, h, device, dtype))
        d = h
    params["out"] = nn.dense_init(gen, d, 1, device, dtype)
    return params


#: the counts of `din_attention` in train mode: the rows its MLP computed
#: (B·P a call) and the real, unpadded, history positions among them
ATTENTION_COUNTS = ("rows", "real")


def din_attention(params, hist_emb: torch.Tensor, hist_ids: torch.Tensor,
                  query_emb: torch.Tensor, *, train: bool = False,
                  dropout_rate: float = 0.0,
                  gen: torch.Generator | None = None,
                  counter: profiling.DeviceCounter | None = None
                  ) -> torch.Tensor:
    """Per-position attention MLP over [hist, query, hist⊙query, hist−query]
    on the flattened [B·P, 4K] rows (dropout after each hidden layer in
    train mode), then the weighted sum over the history with padded
    positions (``hist_ids == 0``) masked out → [B, K].

    hist_emb [B, P, K], hist_ids [B, P], query_emb [B, K]. A padded
    position adds exactly zero, so padding P further leaves the result
    unchanged. In train mode ``counter`` (of `ATTENTION_COUNTS`) adds the
    rows and the real positions on the device.

    CUDA tensors take `din_attention_op.din_attention_unit`: the same
    products, the work round them in hand-written kernels, the same
    forward bitwise; other tensors take `din_attention_plain`."""
    b, p, _ = hist_emb.shape
    if train and counter is not None:
        counter.add(hist_ids, b * p, torch.count_nonzero(hist_ids))
    unit = (din_attention_op.din_attention_unit if hist_emb.is_cuda
            else din_attention_plain)
    return unit(params, hist_emb, hist_ids, query_emb, train=train,
                dropout_rate=dropout_rate, gen=gen)


def din_attention_plain(params, hist_emb: torch.Tensor,
                        hist_ids: torch.Tensor, query_emb: torch.Tensor, *,
                        train: bool = False, dropout_rate: float = 0.0,
                        gen: torch.Generator | None = None) -> torch.Tensor:
    """`din_attention`'s unit in plain PyTorch on any device: the CPU's
    path, and the reference the card's kernels are held to."""
    b, p, k = hist_emb.shape
    query = query_emb[:, None, :].expand(b, p, k)
    h = torch.cat([hist_emb, query, hist_emb * query, hist_emb - query],
                  dim=-1).reshape(b * p, 4 * k)
    for layer in params["mlp"]:
        h = nn.dense(layer, h, activation=torch.relu)
        h = nn.dropout(h, dropout_rate, train, gen)
    wgt = nn.dense(params["out"], h).reshape(b, p, 1)
    mask = (hist_ids > 0).to(hist_emb.dtype)[:, :, None]
    return (hist_emb * wgt * mask).sum(dim=1)
