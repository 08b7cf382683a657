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
one bitwise. The backward (`_backward_cuda`) runs four kernels a unit at
two hidden layers and the products' cuBLAS gradients; it sums in another
order than autograd, in a fixed one (no atomics), so it is deterministic.

`din_attention_unit` draws the dropout uniforms as ``nn.dropout`` draws
them (one ``torch.rand`` a hidden layer, in order, from ``gen``) and
applies `DinAttentionUnit`. CUDA tensors go through the kernels; on CPU
tensors the Function runs the plain version of each kernel (``*_reference``),
which are PyTorch's operations, so its forward equals the plain unit's
there too.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from recsys_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source("din_attention.cu")
#: rows a block of the backward's column kernels takes (``ROWS`` of
#: csrc/din_attention.cu): each writes one partial row of column sums
ROWS_PER_BLOCK = 128
#: index arithmetic on the card is 32-bit: R·max(4K, h_l) must stay below
_MAX_ELEMS = 2 ** 31

#: Kernel launches made by the wrappers (a plain count; read it to show that
#: a run went through the kernels, reset it by assigning 0). A unit with n
#: hidden layers launches n + 2 kernels forward and max(n, 1) + 2 backward.
LAUNCHES = 0
_count_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "din_build": [_P] * 3 + [_I] * 3 + [_P],
    "din_epilogue": [_P] * 3 + [_I] * 2 + [_F] * 2 + [_P],
    "din_pool": [_P] * 6 + [_I] * 3 + [_P],
    "din_head_backward": [_P] * 9 + [_I] * 6 + [_F, _P],
    "din_epilogue_backward": [_P] * 3 + [_I] * 3 + [_F, _P],
    "din_fold": [_P] * 8 + [_I] * 3 + [_P],
    "din_column_sums": [_I] + [ctypes.POINTER(ctypes.c_longlong)] * 2
    + [ctypes.POINTER(ctypes.c_int)] * 2 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if lib.din_build.argtypes is None:
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Run the C entry point ``name`` on ``device``'s current stream (its
    last argument) and count one launch."""
    global LAUNCHES
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    cuda_build.check(lib, err, name)
    with _count_lock:
        LAUNCHES += 1
    cuda_build.tally_launch(f"{__name__}.LAUNCHES", stream)


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


def partials(rows: int, cols, device) -> list[torch.Tensor]:
    """Float64 partial rows [ceil(rows / `ROWS_PER_BLOCK`), c] for each
    width c of ``cols``, views of one workspace, for the backward's
    column kernels."""
    nblk = -(-rows // ROWS_PER_BLOCK)
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


def _backward_cuda(dout, hist, query, ids, wgt, ins, weights, keep):
    """`_backward_plain` on the card: the head kernel, an epilogue-backward
    kernel a hidden layer below the last, the fold kernel and one
    column-sums kernel for every bias and w_out, beside cuBLAS's products.
    The column kernels write partial sums a block of `ROWS_PER_BLOCK` rows
    into one float64 workspace; the column-sums kernel adds them in order
    and rounds each total once to float32."""
    n = len(ins) - 1
    w_out, b_out = weights[-2], weights[-1]
    cols = [t.shape[1] for t in ins[1:]] + [ins[n].shape[1], 1]
    parts = partials(ins[0].shape[0], cols, hist.device)
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
    keep, w_1, b_1, …, w_n, b_n, w_out, b_out)`` → [B, K]. ``rands`` holds
    each hidden layer's uniforms [B·P, h_l] (None each without dropout),
    ``keep`` is 1 − the dropout rate (None without dropout)."""

    @staticmethod
    def forward(ctx, hist, query, ids, rands, keep, *weights):
        n = (len(weights) - 2) // 2
        x = build(hist, query)
        ins = [x]
        for l in range(n):
            z = torch.matmul(ins[-1], weights[2 * l])
            ins.append(epilogue(z, weights[2 * l + 1], rands[l], keep))
        out, wgt = pool(hist, ids, torch.matmul(ins[-1], weights[-2]),
                        weights[-1])
        ctx.save_for_backward(hist, query, ids, wgt, *ins, *weights)
        ctx.hidden, ctx.keep = n, keep
        return out

    @staticmethod
    def backward(ctx, dout):
        hist, query, ids, wgt, *rest = ctx.saved_tensors
        n = ctx.hidden
        ins, weights = rest[:n + 1], rest[n + 1:]
        run = _backward_cuda if hist.is_cuda else _backward_plain
        d_hist, d_query, grads = run(dout.contiguous(), hist, query, ids, wgt,
                                     ins, weights, ctx.keep)
        return (d_hist, d_query, None, None, None, *grads)


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
                       gen: torch.Generator | None = None) -> torch.Tensor:
    """``interactions.din_attention``'s unit through `DinAttentionUnit`,
    each hidden layer's dropout uniforms drawn as ``nn.dropout`` draws them
    (in train mode at a positive rate; a generator is then needed)."""
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
        rands, 1.0 - dropout_rate if drop else None, *weights)
