"""ctypes bridge to the repository's host C++ data plane (counterpart of
``recsys_tpu/data/native.py``): the Criteo TSV parser
(``native/criteo_parser.cc``) and the threaded row gather of the loader's
shuffle (``native/row_gather.cc``).

The library is built from those two files, in place, with
``g++ -O3 -shared -fPIC -pthread`` at first use (`cuda_build.build_all`),
into ``recsys_tpu_torch/_build/`` under a name keyed by the sources' hash
and published with one rename, so processes that build it at once never
load a partial file. Where no compiler exists, or the build fails, every
entry point has a pure-Python path with the same contract. This is host
code: no device kernel runs here.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from recsys_tpu_torch.ops import cuda_build

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = (os.path.join(_REPO_ROOT, "native", "criteo_parser.cc"),
           os.path.join(_REPO_ROOT, "native", "row_gather.cc"))

_lock = threading.Lock()
_lib = None
_tried = False


def _load() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(cuda_build.build_all([SOURCES])[0])
    except (OSError, RuntimeError):
        return None
    lib.parse_criteo_tsv.restype = ctypes.c_long
    lib.parse_criteo_tsv.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_long)]
    lib.gather_rows.restype = None
    lib.gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None where it cannot be
    built (no ``g++``, no ``native/`` sources) or loaded."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if all(os.path.exists(s) for s in SOURCES):
                _lib = _load()
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_criteo_bytes(data: bytes, cat_vocabs: tuple[int, ...]):
    """Criteo TSV bytes → (labels [N], cont [N, 13] with NaN for missing,
    hashed cat ids [N, 26], bytes consumed). Only whole lines are parsed:
    a last line without its newline is left unconsumed. Needs the native
    library (`available`)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    max_rows = data.count(b"\n")          # whole lines only
    if len(cat_vocabs) != 26:
        raise ValueError(f"want 26 categorical vocabs, got {len(cat_vocabs)}")
    labels = np.empty(max_rows, np.float32)
    cont = np.empty((max_rows, 13), np.float32)
    cat = np.empty((max_rows, 26), np.int32)
    vocabs = np.asarray(cat_vocabs, np.int32)
    consumed = ctypes.c_long(0)
    n = lib.parse_criteo_tsv(
        data, len(data), max_rows,
        vocabs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cont.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(consumed))
    return labels[:n], cont[:n], cat[:n], consumed.value


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``out[i] = src[idx[i]]``, the loader's shuffle gather: a threaded
    memcpy of row slices in the native library, numpy fancy indexing
    without it. Indices must lie in [0, len(src)): any other raises
    IndexError on both paths (the native copy checks nothing)."""
    src = np.ascontiguousarray(src)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if len(idx64) and (idx64.min() < 0 or idx64.max() >= len(src)):
        raise IndexError(
            f"gather_rows: index out of range [0, {len(src)}) "
            f"(min={idx64.min()}, max={idx64.max()}); negative indices are "
            "not supported")
    lib = get_lib()
    if lib is None:
        return src[idx64]
    out = np.empty((len(idx64),) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    lib.gather_rows(src.ctypes.data, out.ctypes.data,
                    idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(idx64), row_bytes, min(8, os.cpu_count() or 1))
    return out
