"""DIN's target-attention unit as one autograd Function — the CUDA kernels'
wrappers and their plain versions. The kernels replace no TPU kernel (the
JAX package's ``din_attention`` is elementwise code and dots that XLA
fuses); ``csrc/din_attention.cu`` says what bounds each kernel on the H100
and why the unit's products stay ``torch.matmul`` (cuBLAS).

For history rows R = B·P of width K, query [B, K] and hidden layers
(W_l, b_l) of widths h_1..h_n, one unit computes

    X   = [hist, query, hist⊙query, hist−query]        `build`     [R, 4K]
    A_l = dropout(relu(A_{l−1}·W_l + b_l)), A_0 = X     `epilogue`  [R, h_l]
    wgt = A_n·w_out + b_out                              `pool`      [R]
    out = Σ_p hist·wgt·[id > 0]                                     [B, K]

the products by ``torch.matmul`` on the operands the plain PyTorch unit
(``interactions.din_attention`` on the CPU) multiplies, and everything
else by the kernels, which compute each element with the plain version's
float32 operations in its order: on the card the forward equals the plain
one bitwise. The backward sums in another order than autograd, in a fixed
one (no atomics on a result), so it is deterministic. At the shapes
`FUSED_SHAPES` (two hidden layers, DIN's) it is one kernel and the column
sums (`fused_backward_kernel`): history tiles of `TILE_ROWS` positions
that hold only padding are skipped, and nothing between the unit's output
gradient and its input gradients reaches device memory; its plain version
is `fused_backward_reference`. Any other shape takes `_backward_chain`:
the products' cuBLAS gradients between four kernels.

`din_attention_unit` draws the dropout uniforms as ``nn.dropout`` draws
them (one ``torch.rand`` a hidden layer, in order, from ``gen``) and
applies `DinAttentionUnit`. CUDA tensors go through the kernels; on CPU
tensors the Function runs the plain version of each kernel (``*_reference``),
which are PyTorch's operations, so its forward equals the plain unit's
there too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.ops.cuda_build import F, I, P

#: every kernel's launch counts under ``din_attention``
#: (`cuda_build.launches`); a unit with n hidden layers launches n + 2
#: kernels forward, and backward 2 at `FUSED_SHAPES`, else max(n, 1) + 2
SOURCE = cuda_build.source(
    "din_attention.cu",
    din_build=[P] * 3 + [I] * 3 + [P],
    din_epilogue=[P] * 3 + [I] * 2 + [F] * 2 + [P],
    din_pool=[P] * 6 + [I] * 3 + [P],
    din_head_backward=[P] * 9 + [I] * 6 + [F, P],
    din_epilogue_backward=[P] * 3 + [I] * 3 + [F, P],
    din_fold=[P] * 8 + [I] * 3 + [P],
    din_fused_backward=[P] * 19 + [I] * 6 + [F, P],
    din_column_sums=[I] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(I)] * 2 + [P])
#: rows a block of the backward's column kernels takes (``ROWS`` of
#: csrc/din_attention.cu): each writes one partial row of column sums
ROWS_PER_BLOCK = 128
#: index arithmetic on the card is 32-bit: R·max(4K, h_l) must stay below
_MAX_ELEMS = 2 ** 31
#: (K, h_1, h_2) that ``din_fused_backward`` is built for (its templates)
FUSED_SHAPES = ((32, 80, 40), (16, 80, 40))
#: history positions a tile of the fused backward (``TILE`` of the source),
#: and the most it takes in one example (``LIST`` tiles)
TILE_ROWS = 32
FUSED_MAX_POSITIONS = 256 * TILE_ROWS
#: blocks of the fused backward an SM holds (its ``__launch_bounds__``)
FUSED_BLOCKS_PER_SM = 2


def _launch(name: str, device: torch.device, *args) -> None:
    cuda_build.launch(SOURCE, name, device, *args, counter="din_attention")


def _keep32(keep: float) -> tuple[float, float]:
    """(keep, 1/keep) as the card's dropout uses them: ``rand < keep``
    compares in float32, and PyTorch divides by a Python scalar as a
    product with the float32 reciprocal."""
    k = np.float32(keep)
    return float(k), float(np.float32(1.0) / k)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def build_reference(hist: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """X [B·P, 4K] = [hist, query, hist⊙query, hist−query]."""
    b, p, k = hist.shape
    q = query[:, None, :].expand(b, p, k)
    return torch.cat([hist, q, hist * q, hist - q],
                     dim=-1).reshape(b * p, 4 * k)


def epilogue_reference(z: torch.Tensor, bias: torch.Tensor,
                       rand: torch.Tensor | None,
                       keep: float | None) -> torch.Tensor:
    """dropout(relu(z + bias)): ``rand`` the layer's uniforms (dropout keeps
    ``rand < keep``), or None for no dropout."""
    a = torch.relu(z + bias)
    if rand is None:
        return a
    return torch.where(rand.to(a.device) < keep, a / keep,
                       torch.zeros_like(a))


def pool_reference(hist: torch.Tensor, ids: torch.Tensor, m: torch.Tensor,
                   b_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ_p hist·wgt·[id > 0] [B, K], wgt [B·P]) with wgt = m + b_out, m the
    output layer's product [B·P, 1]."""
    b, p, _ = hist.shape
    wgt = (m + b_out).reshape(b, p, 1)
    mask = (ids > 0).to(hist.dtype)[:, :, None]
    return (hist * wgt * mask).sum(dim=1), wgt.reshape(b * p)


def epilogue_backward_reference(da: torch.Tensor, a: torch.Tensor,
                                keep: float | None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dz, the bias's gradient) through ReLU and dropout from the gradient
    ``da`` of the layer's output ``a``: dz is nonzero where a > 0."""
    scaled = da if keep is None else da / keep
    dz = torch.where(a > 0, scaled, torch.zeros_like(da))
    return dz, dz.sum(dim=0)


def head_backward_reference(dout: torch.Tensor, hist: torch.Tensor,
                            ids: torch.Tensor, a: torch.Tensor,
                            w_out: torch.Tensor, keep: float | None,
                            gated: bool):
    """From the unit's output gradient ``dout`` [B, K]: (dz, the last
    hidden layer's bias gradient (None without ``gated``), w_out's and
    b_out's gradients). ``a`` is the last hidden activation, or X without
    hidden layers (``gated`` False: dz is then X's gradient)."""
    b, p, _ = hist.shape
    real = (ids > 0).reshape(b * p)
    d_wgt = (hist * dout[:, None, :]).sum(dim=-1).reshape(b * p)
    d_wgt = torch.where(real, d_wgt, torch.zeros_like(d_wgt))
    da = d_wgt[:, None] * w_out.reshape(1, -1)
    d_w_out = (a * d_wgt[:, None]).sum(dim=0).reshape(w_out.shape)
    d_b_out = d_wgt.sum().reshape(1)
    if not gated:
        return da, None, d_w_out, d_b_out
    dz, d_b = epilogue_backward_reference(da, a, keep)
    return dz, d_b, d_w_out, d_b_out


def fold_reference(dx: torch.Tensor, dout: torch.Tensor, hist: torch.Tensor,
                   query: torch.Tensor, ids: torch.Tensor, wgt: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_hist [B, P, K], d_query [B, K]) from X's gradient ``dx``
    [B·P, 4K] and the pooling's share dout·wgt·[id > 0]."""
    b, p, k = hist.shape
    dxh, dxq, dxp, dxd = dx.reshape(b, p, 4, k).unbind(dim=2)
    mask = (ids > 0).to(hist.dtype)[:, :, None]
    d_hist = (dxh + dxp * query[:, None, :] + dxd
              + dout[:, None, :] * wgt.reshape(b, p, 1) * mask)
    return d_hist, (dxq + dxp * hist - dxd).sum(dim=1)


# ---------------------------------------------------------------------------
# kernels (CUDA tensors) or plain versions (other devices)
# ---------------------------------------------------------------------------

def build(hist: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """`build_reference`; one kernel on the card."""
    if not hist.is_cuda:
        return build_reference(hist, query)
    b, p, k = hist.shape
    x = torch.empty((b * p, 4 * k), dtype=hist.dtype, device=hist.device)
    _launch("din_build", hist.device, hist.data_ptr(), query.data_ptr(),
            x.data_ptr(), b, p, k)
    return x


def epilogue(z: torch.Tensor, bias: torch.Tensor, rand: torch.Tensor | None,
             keep: float | None) -> torch.Tensor:
    """`epilogue_reference`; on the card one kernel, written over ``z``."""
    if not z.is_cuda:
        return epilogue_reference(z, bias, rand, keep)
    keep32, inv32 = _keep32(keep) if rand is not None else (1.0, 1.0)
    _launch("din_epilogue", z.device, z.data_ptr(), bias.data_ptr(),
            None if rand is None else rand.data_ptr(), z.shape[0],
            z.shape[1], keep32, inv32)
    return z


def pool(hist: torch.Tensor, ids: torch.Tensor, m: torch.Tensor,
         b_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`pool_reference`; on the card one kernel writes wgt and the
    product hist·wgt·mask, and ``torch.sum`` sums it over P as the plain
    version does."""
    if not hist.is_cuda:
        return pool_reference(hist, ids, m, b_out)
    b, p, k = hist.shape
    prod = torch.empty_like(hist)
    wgt = torch.empty((b * p,), dtype=hist.dtype, device=hist.device)
    _launch("din_pool", hist.device, hist.data_ptr(), ids.data_ptr(),
            m.data_ptr(), b_out.data_ptr(), prod.data_ptr(), wgt.data_ptr(),
            b, p, k)
    return prod.sum(dim=1), wgt


def _backward_plain(dout, hist, query, ids, wgt, ins, weights, keep):
    """→ (d_hist, d_query, the weights' gradients), by the plain versions."""
    n = len(ins) - 1
    dz, d_b, d_w_out, d_b_out = head_backward_reference(
        dout, hist, ids, ins[n], weights[-2], keep, gated=n > 0)
    grads = [None] * (2 * n) + [d_w_out, d_b_out]
    for l in reversed(range(n)):
        grads[2 * l] = ins[l].t() @ dz
        grads[2 * l + 1] = d_b
        da = dz @ weights[2 * l].t()            # the gradient of ins[l]
        if l:
            dz, d_b = epilogue_backward_reference(da, ins[l], keep)
        else:
            dz = da
    return (*fold_reference(dz, dout, hist, query, ids, wgt), grads)


def partials(nblk: int, cols, device) -> list[torch.Tensor]:
    """Float64 partial rows [nblk, c] for each width c of ``cols``, views of
    one workspace, for the backward's column kernels (one row a block)."""
    work = torch.empty((nblk * sum(cols),), dtype=torch.float64,
                       device=device)
    return [t.view(nblk, c) for t, c in
            zip(work.split([nblk * c for c in cols]), cols)]


def head_backward_kernel(dout, hist, ids, a, w_out, keep, gated: bool,
                         part_b, part_w, part_bo) -> torch.Tensor:
    """The card's `head_backward_reference`, one kernel → dz; the column
    sums go to the partial rows (`partials`) ``part_b`` (None without
    ``gated``), ``part_w`` [·, h] and ``part_bo`` [·, 1]."""
    b, p, k = hist.shape
    rows, h = a.shape
    dz = torch.empty((rows, h), dtype=hist.dtype, device=hist.device)
    _launch("din_head_backward", hist.device, dout.data_ptr(),
            hist.data_ptr(), ids.data_ptr(), a.data_ptr(), w_out.data_ptr(),
            dz.data_ptr(), None if part_b is None else part_b.data_ptr(),
            part_w.data_ptr(), part_bo.data_ptr(), b, p, k, h, int(gated),
            int(keep is not None),
            _keep32(keep)[1] if keep is not None else 1.0)
    return dz


def epilogue_backward_kernel(da, a, keep, part_b) -> torch.Tensor:
    """The card's `epilogue_backward_reference`, one kernel: dz written
    over ``da``, the bias's column sums to the partial rows ``part_b``."""
    _launch("din_epilogue_backward", da.device, da.data_ptr(), a.data_ptr(),
            part_b.data_ptr(), da.shape[0], da.shape[1],
            int(keep is not None),
            _keep32(keep)[1] if keep is not None else 1.0)
    return da


def fold_kernel(dx, dout, hist, query, ids, wgt):
    """The card's `fold_reference`, one kernel."""
    b, p, k = hist.shape
    d_hist = torch.empty_like(hist)
    d_query = torch.empty_like(query)
    _launch("din_fold", hist.device, dx.data_ptr(), dout.data_ptr(),
            hist.data_ptr(), query.data_ptr(), ids.data_ptr(),
            wgt.data_ptr(), d_hist.data_ptr(), d_query.data_ptr(), b, p, k)
    return d_hist, d_query


def column_sums_kernel(parts, device) -> list[torch.Tensor]:
    """Each of the partial rows ``parts`` summed over its rows in a fixed
    order, rounded once to float32: one kernel for up to 16 of them."""
    outs = [torch.empty((t.shape[1],), dtype=torch.float32, device=device)
            for t in parts]
    addresses = ctypes.c_longlong * len(parts)
    counts = ctypes.c_int * len(parts)
    _launch("din_column_sums", device, len(parts),
            addresses(*(t.data_ptr() for t in parts)),
            addresses(*(t.data_ptr() for t in outs)),
            counts(*(t.shape[0] for t in parts)),
            counts(*(t.shape[1] for t in parts)))
    return outs


def fused_backward_reference(dout, hist, query, ids, wgt, ins, weights,
                             keep):
    """The plain version of ``din_fused_backward``: `_backward_plain` of a
    unit with two hidden layers, by the kernel's algebra → (d_hist,
    d_query, the weights' gradients, (tiles, tiles computed)).

    History positions go in tiles of `TILE_ROWS`; a tile whose ids are all
    0 computes nothing (its rows' d_wgt is 0, so is everything downstream).
    X = [h, q, h⊙q, h−q] is not used: with G = Σ_p hᵀ·dZ1 [K, h_1] and
    s = Σ_p dZ1 of each example, d_hist = dZ1·W_effᵀ with W_eff = W1_h +
    q·W1_p + W1_d, d_query = s·(W1_q − W1_d)ᵀ + Σ_i W1_p⊙G, and dW1's row
    groups are Σ G, Σ q⊗s, Σ q·G and Σ G − q⊗s."""
    b, p, k = hist.shape
    (w1, _, w2, _, w_out, _), (a1, a2) = weights, ins[1:]
    scale = 1.0 if keep is None else _keep32(keep)[1]
    nt = -(-p // TILE_ROWS)
    real = ids > 0
    computed = torch.nn.functional.pad(real, (0, nt * TILE_ROWS - p)).view(
        b, nt, TILE_ROWS).any(dim=-1)
    d_wgt = (hist * dout[:, None, :]).sum(dim=-1).reshape(b * p)
    d_wgt = torch.where(real.reshape(-1), d_wgt, torch.zeros_like(d_wgt))
    dz2 = torch.where(a2 > 0, d_wgt[:, None] * w_out.reshape(1, -1) * scale,
                      torch.zeros_like(a2))
    dz1 = torch.where(a1 > 0, (dz2 @ w2.t()) * scale, torch.zeros_like(a1))
    z1 = dz1.reshape(b, p, -1)
    g = torch.einsum("bpk,bpi->bki", hist, z1)
    s = z1.sum(dim=1)
    w1h, w1q, w1p, w1d = w1.split(k)
    weff = w1h + query[:, :, None] * w1p + w1d
    mask = real.to(hist.dtype)[:, :, None]
    d_hist = (torch.einsum("bpi,bki->bpk", z1, weff)
              + dout[:, None, :] * wgt.reshape(b, p, 1) * mask)
    d_query = s @ (w1q - w1d).t() + (w1p * g).sum(dim=-1)
    gsum = g.sum(dim=0)
    qs = (query[:, :, None] * s[:, None, :]).sum(dim=0)
    d_w1 = torch.cat([gsum, qs, (query[:, :, None] * g).sum(dim=0),
                      gsum - qs])
    grads = [d_w1, s.sum(dim=0), a1.t() @ dz2, dz2.sum(dim=0),
             (a2 * d_wgt[:, None]).sum(dim=0).reshape(w_out.shape),
             d_wgt.sum().reshape(1)]
    return d_hist, d_query, grads, (b * nt, int(computed.sum()))


def fused_backward_kernel(dout, hist, query, ids, wgt, ins, weights, keep,
                          tiles: torch.Tensor | None = None):
    """The card's `fused_backward_reference`: ``din_fused_backward``, which
    writes d_hist, d_query and one float64 partial row of every weight's
    and bias's gradient a block, then one column-sums kernel. ``tiles`` (an
    int64 [2] on the card, or None) gains the tiles in all and the tiles
    computed, on the card."""
    b, p, k = hist.shape
    (w1, _, w2, _, w_out, b_out), (a1, a2) = weights, ins[1:]
    h1, h2 = w2.shape
    props = torch.cuda.get_device_properties(hist.device)
    grid = min(b, FUSED_BLOCKS_PER_SM * props.multi_processor_count)
    parts = partials(grid, [4 * k * h1, h1, h1 * h2, h2, h2, 1],
                     hist.device)
    d_hist = torch.empty_like(hist)
    d_query = torch.empty_like(query)
    _launch("din_fused_backward", hist.device, dout.data_ptr(),
            hist.data_ptr(), query.data_ptr(), ids.data_ptr(),
            wgt.data_ptr(), a1.data_ptr(), a2.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), w_out.data_ptr(), d_hist.data_ptr(),
            d_query.data_ptr(), *(t.data_ptr() for t in parts),
            None if tiles is None else tiles.data_ptr(), b, p, k, h1, h2,
            grid, _keep32(keep)[1] if keep is not None else 1.0)
    sums = column_sums_kernel(parts, hist.device)
    grads = [sums[0].view(4 * k, h1), sums[1], sums[2].view(h1, h2),
             sums[3], sums[4].reshape(w_out.shape),
             sums[5].reshape(b_out.shape)]
    return d_hist, d_query, grads


def fused(hist, ins, weights) -> bool:
    """Whether the unit's backward takes `fused_backward_kernel`: two
    hidden layers at one of `FUSED_SHAPES`, a history of at most
    `FUSED_MAX_POSITIONS`, and operands aligned for float4 loads."""
    b, p, k = hist.shape
    return (len(ins) == 3 and b * p > 0 and p <= FUSED_MAX_POSITIONS
            and (k, *(w.shape[1] for w in weights[:4:2])) in FUSED_SHAPES
            and all(t.data_ptr() % 16 == 0 for t in (hist, *ins[1:])))


def _backward_cuda(dout, hist, query, ids, wgt, ins, weights, keep, tiles):
    """`_backward_plain` on the card: `fused_backward_kernel` where `fused`
    holds, else `_backward_chain`."""
    if fused(hist, ins, weights):
        return fused_backward_kernel(dout, hist, query, ids, wgt, ins,
                                     weights, keep, tiles)
    return _backward_chain(dout, hist, query, ids, wgt, ins, weights, keep)


def _backward_chain(dout, hist, query, ids, wgt, ins, weights, keep):
    """`_backward_plain` on the card at any shape: the head kernel, an
    epilogue-backward kernel a hidden layer below the last, the fold kernel
    and one column-sums kernel for every bias and w_out, beside cuBLAS's
    products.
    The column kernels write partial sums a block of `ROWS_PER_BLOCK` rows
    into one float64 workspace; the column-sums kernel adds them in order
    and rounds each total once to float32."""
    n = len(ins) - 1
    w_out, b_out = weights[-2], weights[-1]
    cols = [t.shape[1] for t in ins[1:]] + [ins[n].shape[1], 1]
    parts = partials(-(-ins[0].shape[0] // ROWS_PER_BLOCK), cols,
                     hist.device)
    dz = head_backward_kernel(dout, hist, ids, ins[n], w_out, keep, n > 0,
                              parts[n - 1] if n else None, parts[n],
                              parts[n + 1])
    grads = [None] * (2 * n)
    for l in reversed(range(n)):
        grads[2 * l] = torch.mm(ins[l].t(), dz)
        dz = torch.mm(dz, weights[2 * l].t())
        if l:
            dz = epilogue_backward_kernel(dz, ins[l], keep, parts[l - 1])
    d_hist, d_query = fold_kernel(dz, dout, hist, query, ids, wgt)
    sums = column_sums_kernel(parts, hist.device)
    grads[1::2] = sums[:n]
    grads += [sums[n].reshape(w_out.shape), sums[n + 1].reshape(b_out.shape)]
    return d_hist, d_query, grads


class DinAttentionUnit(torch.autograd.Function):
    """One unit: ``apply(hist [B, P, K], query [B, K], ids [B, P], rands,
    keep, tiles, w_1, b_1, …, w_n, b_n, w_out, b_out)`` → [B, K]. ``rands``
    holds each hidden layer's uniforms [B·P, h_l] (None each without
    dropout), ``keep`` is 1 − the dropout rate (None without dropout),
    ``tiles`` the int64 [2] that the fused backward adds its tile counts to
    (`fused_backward_kernel`), or None."""

    @staticmethod
    def forward(ctx, hist, query, ids, rands, keep, tiles, *weights):
        n = (len(weights) - 2) // 2
        x = build(hist, query)
        ins = [x]
        for l in range(n):
            z = torch.matmul(ins[-1], weights[2 * l])
            ins.append(epilogue(z, weights[2 * l + 1], rands[l], keep))
        out, wgt = pool(hist, ids, torch.matmul(ins[-1], weights[-2]),
                        weights[-1])
        ctx.save_for_backward(hist, query, ids, wgt, *ins, *weights)
        ctx.hidden, ctx.keep, ctx.tiles = n, keep, tiles
        return out

    @staticmethod
    def backward(ctx, dout):
        hist, query, ids, wgt, *rest = ctx.saved_tensors
        n = ctx.hidden
        ins, weights = rest[:n + 1], rest[n + 1:]
        args = (dout.contiguous(), hist, query, ids, wgt, ins, weights,
                ctx.keep)
        d_hist, d_query, grads = (_backward_cuda(*args, ctx.tiles)
                                  if hist.is_cuda else _backward_plain(*args))
        return (d_hist, d_query, None, None, None, None, *grads)


def _check(hist, ids, query, weights) -> None:
    b, p, k = hist.shape
    if tuple(ids.shape) != (b, p) or tuple(query.shape) != (b, k):
        raise ValueError(f"din_attention: hist {tuple(hist.shape)}, ids "
                         f"{tuple(ids.shape)} and query "
                         f"{tuple(query.shape)} do not agree")
    for t in (hist, query, *weights):
        if t.dtype != torch.float32:
            raise TypeError(f"din_attention: {t.dtype} on the card, the "
                            "kernels take float32")
        if t.device != hist.device:
            raise ValueError(f"din_attention: a tensor on {t.device}, hist "
                             f"on {hist.device}")
    widest = max([4 * k] + [w.shape[-1] for w in weights[:-2:2]])
    if b * p * widest >= _MAX_ELEMS:
        raise ValueError(f"din_attention: {b * p} rows of up to {widest} "
                         f"columns exceed the kernels' 32-bit indexing")


def din_attention_unit(params, hist_emb: torch.Tensor,
                       hist_ids: torch.Tensor, query_emb: torch.Tensor, *,
                       train: bool = False, dropout_rate: float = 0.0,
                       gen: torch.Generator | None = None,
                       tiles: torch.Tensor | None = None) -> torch.Tensor:
    """``interactions.din_attention``'s unit through `DinAttentionUnit`,
    each hidden layer's dropout uniforms drawn as ``nn.dropout`` draws them
    (in train mode at a positive rate; a generator is then needed);
    ``tiles`` as the Function takes it."""
    b, p, _ = hist_emb.shape
    drop = train and dropout_rate > 0.0
    if drop and gen is None:
        raise ValueError("dropout in train mode needs a generator")
    weights = []
    for layer in (*params["mlp"], params["out"]):
        weights += [layer["w"], layer["b"]]
    rands = [torch.rand((b * p, layer["w"].shape[1]), generator=gen,
                        device=gen.device).to(hist_emb.device)
             if drop else None for layer in params["mlp"]]
    ids = hist_ids
    if hist_emb.is_cuda:
        _check(hist_emb, hist_ids, query_emb, weights)
        ids = ids.to(torch.int64)           # what the kernels read
        weights = [w.contiguous() for w in weights]
    return DinAttentionUnit.apply(
        hist_emb.contiguous(), query_emb.contiguous(), ids.contiguous(),
        rands, 1.0 - dropout_rate if drop else None, tiles, *weights)
