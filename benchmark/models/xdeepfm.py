"""xDeepFM's plain reference (wangruichens/recsys ``xdeepfm/xdeepfm.py``):

    linear_y = relu(dense(dense values) + Σ_{f categorical} wide[id_f])
    CIN: x^{k+1}[h, d] = relu(Σ_{p,q} W_k[(p, q), h] · x^0[p, d] · x^k[q, d]
                              + b_k[h]),  pooled over d, every layer
    cin_y    = relu(dense(concat_k pool_k))
    dnn_y    = relu(dense(MLP(concat_f e_f)))
    logit    = dense([linear_y, cin_y, dnn_y])

in the configuration's field order, every product through ``mm``; the
outer product z of each CIN layer is formed in memory.
Plain PyTorch: imports nothing of the port.
"""

from __future__ import annotations

import torch

from benchmark.models import criteo


def spec(config: dict) -> list:
    """(path, shape, init) of every weight."""
    n_fields = len(criteo.field_vocabs(config))
    d = config["embedding_dim"]
    n_cont = len(config["cont_boundaries"])
    out = criteo.table_spec(config)
    out += criteo.dense_spec(("lin_dense",), n_cont, 1)
    fk = n_fields
    for i, h in enumerate(config["cin_layers"]):
        out += [(("cin", i, "w"), (fk * n_fields, h),
                 ("glorot", fk * n_fields, h)),
                (("cin", i, "b"), (h,), ("zeros",))]
        fk = h
    out += criteo.dense_spec(("cin_out",), sum(config["cin_layers"]), 1)
    out += criteo.mlp_spec(config, n_fields * d)
    out += criteo.dense_spec(("dnn_out",), config["deep_layers"][-1], 1)
    out += criteo.dense_spec(("final",), 3, 1)
    return out


def cin(layers: list, emb: torch.Tensor, mm) -> torch.Tensor:
    """Pooled CIN outputs [B, Σ_k H_k] of embeddings [B, F, D]."""
    b, f, d = emb.shape
    x0 = emb.transpose(1, 2).reshape(b * d, f)
    xk = x0
    pools = []
    for layer in layers:
        z = (x0[:, :, None] * xk[:, None, :]).reshape(b * d, -1)
        xk = torch.relu(mm(z, layer["w"]) + layer["b"])
        pools.append(xk.reshape(b, d, -1).sum(dim=1))
    return torch.cat(pools, dim=1)


def forward(config: dict, params: dict, ids, dense_vals, masks,
            mm) -> torch.Tensor:
    """Train-mode logits [B] with the dropout masks given."""
    emb, wide = criteo.lookup(config, params, ids)
    n_cont = len(config["cont_boundaries"])
    linear_y = torch.relu(criteo.dense(params["lin_dense"], dense_vals, mm)
                          + wide[:, n_cont:].sum(dim=1, keepdim=True))
    cin_y = torch.relu(criteo.dense(params["cin_out"],
                                    cin(params["cin"], emb, mm), mm))
    h = criteo.mlp(config, params["dnn"]["layers"],
                   emb.reshape(emb.shape[0], -1), masks, mm)
    dnn_y = torch.relu(criteo.dense(params["dnn_out"], h, mm))
    return criteo.dense(params["final"],
                        torch.cat([linear_y, cin_y, dnn_y], dim=1), mm)[:, 0]


def _cin_shapes(config: dict, batch: int):
    """(N, F0, Fk, H) of each CIN layer at batch ``batch``."""
    f0 = len(criteo.field_vocabs(config))
    n = batch * config["embedding_dim"]
    fk, out = f0, []
    for h in config["cin_layers"]:
        out.append((n, f0, fk, h))
        fk = h
    return out


def forward_flops(config: dict) -> float:
    """Model flops of one example's forward pass: the CIN (the outer
    product's F0·Fk multiplies and 2 per multiply-add of z·W, over the D
    positions of each layer), 2 per multiply-add of the dense layers.
    Lookups count none."""
    n_cont = len(config["cont_boundaries"])
    f0 = len(criteo.field_vocabs(config))
    cin_flops = sum(n * f0_ * fk * (1 + 2 * h)
                    for n, f0_, fk, h in _cin_shapes(config, 1))
    return (cin_flops + criteo.dnn_flops(config, f0 * config["embedding_dim"])
            + 2.0 * (n_cont + sum(config["cin_layers"]) + 3))


def cin_fwd_work(n: int, f0: int, fk: int, h: int) -> tuple[float, float]:
    """(bytes, flops) of one CIN layer forward: read x0v [N, F0], xkv
    [N, Fk] (the same tensor at the first layer), W, b; write y [N, H]; the
    outer product, z·W, bias and ReLU."""
    xk_bytes = 0 if fk == f0 else 4 * n * fk
    nbytes = 4 * (n * f0 + f0 * fk * h + h + n * h) + xk_bytes
    return nbytes, n * f0 * fk + 2 * n * f0 * fk * h + 2 * n * h


def cin_bwd_work(n: int, f0: int, fk: int, h: int) -> tuple[float, float]:
    """(bytes, flops) of one CIN layer backward: read x0v, xkv, W, y, dy;
    write dx0, dxk, dW, db; dz = g·Wᵀ, dx0 and dxk from dz, z again for
    dW = zᵀg, db."""
    nbytes = 4 * (2 * (n * f0 + n * fk + f0 * fk * h + n * h) + h)
    flops = (2 * n * h * f0 * fk + 4 * n * f0 * fk + n * f0 * fk
             + 2 * n * f0 * fk * h + 2 * n * h)
    return nbytes, flops


def kernel_work(config: dict, traffic: dict) -> dict:
    """(bytes, flops) of each launch of the port's kernels in one step, by
    family."""
    shapes = _cin_shapes(config, traffic["batch"])
    return {"embedding": criteo.embedding_work(config, traffic),
            "cin": ([cin_fwd_work(*s) for s in shapes]
                    + [cin_bwd_work(*s) for s in shapes])}
