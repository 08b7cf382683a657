"""Fused CIN layer: the hand-written CUDA kernel, its wrapper and its plain
version (counterpart of ``recsys_tpu/ops/pallas_cin.py``, forward only).

One CIN layer maps feature maps in the embedding-dim-fused layout of
`interactions.cin_apply` — x0v [N=B·D, F0] and xkv [N, Fk] — to

    y = relu(z @ w + b),   z[n, p·Fk+q] = x0v[n, p] · xkv[n, q]

with w [F0·Fk, H] and b [H]. The CUDA kernel (``csrc/cin_layer.cu``, whose
header says what bounds it on the H100 and how its design answers) forms z
in registers and never writes it to memory; the plain version materializes
z and calls one matmul.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``recsys_tpu_torch/_build/`` under a name keyed by the source's hash, and is
loaded with ctypes. ``cin_layer`` launches it for CUDA tensors (or raises);
it takes the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "cin_layer.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
MAX_H = 32   # accumulators per thread (csrc/cin_layer.cu instantiates 1..32)

#: Kernel launches made by `cin_layer` (a plain count; read it to show that a
#: run went through the kernel, reset it by assigning 0).
LAUNCHES = 0
_count_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    """nvcc of $CUDA_HOME, else the one on $PATH, else /usr/local/cuda's."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is "
                       "needed to build " + SOURCE)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcin_layer_{digest}.so")


def build() -> str:
    """Compile the kernel unless a library of this source exists; → path.
    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of each instantiation) is kept beside it as ``<path>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        with open(path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)   # atomic publish: readers see all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.cin_layer_fwd.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            lib.cin_layer_fwd.restype = ctypes.c_int
            lib.cin_error_string.argtypes = [ctypes.c_int]
            lib.cin_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def cin_layer_reference(x0v: torch.Tensor, xkv: torch.Tensor,
                        w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: materialize z, one matmul."""
    n, f0 = x0v.shape
    fk = xkv.shape[1]
    z = (x0v[:, :, None] * xkv[:, None, :]).reshape(n, f0 * fk)
    return torch.relu(z @ w + b)


def _check(x0v, xkv, w, b) -> None:
    tensors = {"x0v": x0v, "xkv": xkv, "w": w, "b": b}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"cin_layer: {name} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"cin_layer: {name} is not contiguous")
        if t.device != x0v.device:
            raise ValueError(f"cin_layer: {name} is on {t.device}, x0v on "
                             f"{x0v.device}")
    if x0v.dim() != 2 or xkv.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("cin_layer: want x0v [N, F0], xkv [N, Fk], "
                         "w [F0·Fk, H], b [H]")
    n, f0 = x0v.shape
    fk = xkv.shape[1]
    h = w.shape[1]
    if xkv.shape[0] != n or w.shape[0] != f0 * fk or b.shape[0] != h:
        raise ValueError(
            f"cin_layer: shapes x0v {tuple(x0v.shape)}, xkv "
            f"{tuple(xkv.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)} "
            "do not agree")
    if not 1 <= h <= MAX_H:
        raise ValueError(f"cin_layer: H={h} outside 1..{MAX_H}")
    if n * max(f0, fk) >= 2 ** 31:
        raise ValueError(f"cin_layer: N={n} rows overflow 32-bit indexing")


def cin_layer(x0v: torch.Tensor, xkv: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One CIN layer relu(outer(x0v, xkv) @ w + b) → [N, H], float32.

    CUDA tensors go through the kernel; the call raises if it cannot launch.
    CPU tensors go through `cin_layer_reference`."""
    global LAUNCHES
    _check(x0v, xkv, w, b)
    if x0v.device.type == "cpu":
        return cin_layer_reference(x0v, xkv, w, b)
    if x0v.device.type != "cuda":
        raise ValueError(f"cin_layer: no kernel for device {x0v.device}")
    n, f0 = x0v.shape
    fk, h = xkv.shape[1], w.shape[1]
    y = torch.empty((n, h), dtype=torch.float32, device=x0v.device)
    if n == 0:
        return y
    lib = _load()
    with torch.cuda.device(x0v.device):
        stream = torch.cuda.current_stream(x0v.device).cuda_stream
        err = lib.cin_layer_fwd(x0v.data_ptr(), xkv.data_ptr(), w.data_ptr(),
                                b.data_ptr(), y.data_ptr(), n, f0, fk, h,
                                stream)
    if err != 0:
        raise RuntimeError(f"cin_layer_fwd launch failed: error {err} "
                           f"({lib.cin_error_string(err).decode()})")
    with _count_lock:
        LAUNCHES += 1
    return y


def cin_apply_fused(params, x0: torch.Tensor) -> torch.Tensor:
    """CIN forward through `cin_layer` → pooled concat [B, Σ_k H_k].

    Same layout as `interactions.cin_apply`: x0 [B, F0, D] becomes
    x0v [B·D, F0], each layer's [B·D, H] output is sum-pooled over D."""
    b, f0, d = x0.shape
    x0v = x0.transpose(1, 2).reshape(b * d, f0).contiguous()
    xkv = x0v
    pooled = []
    for layer in params:
        xkv = cin_layer(x0v, xkv, layer["w"], layer["b"])
        pooled.append(xkv.reshape(b, d, -1).sum(dim=1))
    return torch.cat(pooled, dim=1)
