"""Fused CIN layer: the hand-written CUDA kernels (forward and backward),
their wrappers and their plain versions (counterpart of
``recsys_tpu/ops/pallas_cin.py``).

One CIN layer maps feature maps in the embedding-dim-fused layout of
`interactions.cin_apply` — x0v [N=B·D, F0] and xkv [N, Fk] — to

    y = relu(z @ w + b),   z[n, p·Fk+q] = x0v[n, p] · xkv[n, q]

with w [F0·Fk, H] and b [H]. The forward kernel (``csrc/cin_layer.cu``)
forms z in registers and never writes it to memory; the backward kernel
(``csrc/cin_backward.cu``) recomputes z the same way and returns dx0, dxk,
dW and db (each source's header says what bounds it on the H100 and how its
design answers). The plain versions materialize z and use matmuls.

`cin_layer` is a ``torch.autograd.Function``: forward `cin_layer_fwd`,
backward `cin_layer_bwd`, as the JAX package pairs the two Pallas kernels
through ``jax.custom_vjp``. Both wrappers launch their kernel for CUDA
tensors (or raise) and take the plain version only for tensors on the CPU.
The kernels are built at first use (`cuda_build`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from recsys_tpu_torch.ops import cuda_build

SOURCE = cuda_build.source("cin_layer.cu")
BWD_SOURCE = cuda_build.source("cin_backward.cu")
MAX_H = 32   # accumulators per thread (both sources instantiate H = 1..32)
_SMS = 132             # the H100 SXM's SMs: the dW pass's groups fill them
_DW_MIN_ROWS = 64      # rows per dW partial sum, at least

#: Forward kernel launches made by `cin_layer_fwd`, and backward kernel
#: launches made by `cin_layer_bwd` (plain counts; read them to show that a
#: run went through the kernels, reset them by assigning 0).
LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()


def _fwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    if lib.cin_layer_fwd.argtypes is None:
        lib.cin_layer_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.cin_layer_fwd.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load(BWD_SOURCE)
    if lib.cin_layer_bwd.argtypes is None:
        lib.cin_layer_bwd.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.cin_layer_bwd.restype = ctypes.c_int
    return lib


def cin_layer_reference(x0v: torch.Tensor, xkv: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain forward: materialize z, one matmul."""
    n, f0 = x0v.shape
    fk = xkv.shape[1]
    z = (x0v[:, :, None] * xkv[:, None, :]).reshape(n, f0 * fk)
    return torch.relu(z @ w + b)


def cin_layer_backward_reference(x0v, xkv, w, y, dy):
    """The plain backward → (dx0, dxk, dw, db): materialize z and dz."""
    n, f0 = x0v.shape
    fk = xkv.shape[1]
    g = dy * (y > 0)
    dz = (g @ w.t()).reshape(n, f0, fk)
    dx0 = (dz * xkv[:, None, :]).sum(dim=2)
    dxk = (dz * x0v[:, :, None]).sum(dim=1)
    z = (x0v[:, :, None] * xkv[:, None, :]).reshape(n, f0 * fk)
    return dx0, dxk, z.t() @ g, g.sum(dim=0)


def _check(x0v, xkv, w, **others) -> None:
    """Raise on what the kernels do not take; ``others`` are b [H] (the
    forward) or y and dy [N, H] (the backward)."""
    tensors = {"x0v": x0v, "xkv": xkv, "w": w, **others}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"cin_layer: {name} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"cin_layer: {name} is not contiguous")
        if t.device != x0v.device:
            raise ValueError(f"cin_layer: {name} is on {t.device}, x0v on "
                             f"{x0v.device}")
    if x0v.dim() != 2 or xkv.dim() != 2 or w.dim() != 2:
        raise ValueError("cin_layer: want x0v [N, F0], xkv [N, Fk], "
                         "w [F0·Fk, H]")
    n, f0 = x0v.shape
    fk = xkv.shape[1]
    h = w.shape[1]
    want = {"b": (h,), "y": (n, h), "dy": (n, h)}
    if xkv.shape[0] != n or w.shape[0] != f0 * fk or any(
            tuple(t.shape) != want[k] for k, t in others.items()):
        raise ValueError(
            f"cin_layer: shapes x0v {tuple(x0v.shape)}, xkv "
            f"{tuple(xkv.shape)}, w {tuple(w.shape)}, "
            + ", ".join(f"{k} {tuple(t.shape)}" for k, t in others.items())
            + " do not agree")
    if not 1 <= h <= MAX_H:
        raise ValueError(f"cin_layer: H={h} outside 1..{MAX_H}")
    if n * max(f0, fk, h) >= 2 ** 31:
        raise ValueError(f"cin_layer: N={n} rows overflow 32-bit indexing")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def cin_layer_fwd(x0v: torch.Tensor, xkv: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """One CIN layer forward relu(outer(x0v, xkv) @ w + b) → [N, H] float32,
    outside autograd. CUDA tensors go through the kernel (the call raises if
    it cannot launch); CPU tensors through `cin_layer_reference`."""
    global LAUNCHES
    _check(x0v, xkv, w, b=b)
    if x0v.device.type == "cpu":
        return cin_layer_reference(x0v, xkv, w, b)
    if x0v.device.type != "cuda":
        raise ValueError(f"cin_layer: no kernel for device {x0v.device}")
    n, f0 = x0v.shape
    fk, h = xkv.shape[1], w.shape[1]
    y = torch.empty((n, h), dtype=torch.float32, device=x0v.device)
    if n == 0:
        return y
    lib = _fwd_lib()
    stream = _stream(x0v.device)
    with torch.cuda.device(x0v.device):
        err = lib.cin_layer_fwd(x0v.data_ptr(), xkv.data_ptr(), w.data_ptr(),
                                b.data_ptr(), y.data_ptr(), n, f0, fk, h,
                                stream)
    cuda_build.check(lib, err, "cin_layer_fwd")
    with _count_lock:
        LAUNCHES += 1
    cuda_build.tally_launch(f"{__name__}.LAUNCHES", stream)
    return y


def _dw_groups(n: int, f0: int, fk: int) -> tuple[int, int]:
    """(groups, rows per group) of the dW pass's partial sums: a function of
    the shape alone, so the summation order and the result are fixed for a
    shape. A block of the pass has one thread per 4 z columns (plus the
    bias column); at large N the groups are 132 (one block per SM) times
    the blocks of that size that make about 16 warps an SM, at most 4."""
    warps = -(-(f0 * -(-fk // 4) + 1) // 32)
    per_sm = max(1, min(4, 16 // warps))
    target = max(1, min(_SMS * per_sm, -(-n // _DW_MIN_ROWS)))
    rows = -(-n // target)
    return -(-n // rows), rows


def _dw_part_floats(f0: int, fk: int, h: int) -> int:
    """Floats of one row group's dW partial sums, laid out as the kernel
    writes them: [H][tile][4], a tile being 4 columns of z (one p, 4
    consecutive q, the last tile of a p padded) and one more tile for the
    bias, so that each store of a warp is contiguous."""
    return h * (f0 * -(-fk // 4) + 1) * 4


def _wt_floats(f0: int, fk: int, h: int) -> int:
    """Floats of W as the rows pass stages it: [pass][F0][H][8], a pass
    being the 8 q values of a lane pair's two 4-q tiles (zero beyond Fk)."""
    return -(-fk // 8) * f0 * h * 8


def cin_layer_bwd(x0v: torch.Tensor, xkv: torch.Tensor, w: torch.Tensor,
                  y: torch.Tensor, dy: torch.Tensor):
    """One CIN layer backward from the forward's inputs, its output ``y``
    (the ReLU mask) and the output gradient ``dy`` → (dx0, dxk, dw, db).
    CUDA tensors go through the kernel (the call raises if it cannot
    launch); CPU tensors through `cin_layer_backward_reference`."""
    global BWD_LAUNCHES
    _check(x0v, xkv, w, y=y, dy=dy)
    n, f0 = x0v.shape
    fk, h = xkv.shape[1], w.shape[1]
    if x0v.device.type == "cpu":
        return cin_layer_backward_reference(x0v, xkv, w, y, dy)
    if x0v.device.type != "cuda":
        raise ValueError(f"cin_layer: no kernel for device {x0v.device}")
    dev = x0v.device
    dx0 = torch.empty((n, f0), dtype=torch.float32, device=dev)
    dxk = torch.empty((n, fk), dtype=torch.float32, device=dev)
    if n == 0:
        return dx0, dxk, torch.zeros_like(w), torch.zeros(h, device=dev)
    dw = torch.empty_like(w)
    db = torch.empty((h,), dtype=torch.float32, device=dev)
    groups, rows = _dw_groups(n, f0, fk)
    part_floats = groups * _dw_part_floats(f0, fk, h)   # a multiple of 4
    work = torch.empty(part_floats + _wt_floats(f0, fk, h),
                       dtype=torch.float32, device=dev)
    lib = _bwd_lib()
    stream = _stream(dev)
    with torch.cuda.device(dev):
        err = lib.cin_layer_bwd(
            x0v.data_ptr(), xkv.data_ptr(), w.data_ptr(), y.data_ptr(),
            dy.data_ptr(), dx0.data_ptr(), dxk.data_ptr(), work.data_ptr(),
            work[part_floats:].data_ptr(), dw.data_ptr(), db.data_ptr(), n,
            f0, fk, h, groups, rows, stream)
    cuda_build.check(lib, err, "cin_layer_bwd")
    with _count_lock:
        BWD_LAUNCHES += 1
    cuda_build.tally_launch(f"{__name__}.BWD_LAUNCHES", stream)
    return dx0, dxk, dw, db


class _CinLayer(torch.autograd.Function):
    """Forward `cin_layer_fwd`; backward `cin_layer_bwd` from the saved
    inputs and ReLU output (``pallas_cin._cin_layer_fwd``/``_bwd``)."""

    @staticmethod
    def forward(ctx, x0v, xkv, w, b):
        y = cin_layer_fwd(x0v, xkv, w, b)
        ctx.save_for_backward(x0v, xkv, w, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x0v, xkv, w, y = ctx.saved_tensors
        return cin_layer_bwd(x0v, xkv, w, y, dy.contiguous())


def cin_layer(x0v: torch.Tensor, xkv: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One differentiable CIN layer relu(outer(x0v, xkv) @ w + b) → [N, H],
    float32: `cin_layer_fwd` forward, `cin_layer_bwd` backward."""
    return _CinLayer.apply(x0v, xkv, w, b)


def cin_apply_fused(params, x0: torch.Tensor) -> torch.Tensor:
    """CIN forward through `cin_layer` → pooled concat [B, Σ_k H_k].

    Same layout as `interactions.cin_apply`: x0 [B, F0, D] becomes
    x0v [B·D, F0], each layer's [B·D, H] output is sum-pooled over D. x0v
    feeds every layer, so autograd sums its gradient over the layers."""
    b, f0, d = x0.shape
    x0v = x0.transpose(1, 2).reshape(b * d, f0).contiguous()
    xkv = x0v
    pooled = []
    for layer in params:
        xkv = cin_layer(x0v, xkv, layer["w"], layer["b"])
        pooled.append(xkv.reshape(b, d, -1).sum(dim=1))
    return torch.cat(pooled, dim=1)
