"""The port's one launch path for its CUDA kernels (``ops/cuda_build.py``)
on the CPU, where no kernel is built:

- every kernel source, ``csrc/*.cu``, is declared by its wrapper with the
  C signature of each entry point it calls, argument for argument (a
  pointer, ``int``, ``long long``, ``unsigned long long`` or ``float``);
- `launch`, with the library and CUDA's device and stream stood in for,
  calls the entry point with the stream last, counts its launches under
  the counter given (the entry's name by default) in the registry and in
  the stream's open tally, and raises with the entry's name, counting
  nothing, when the launch is refused;
- `counting` and `recount` read and move the registry by name.
"""

import contextlib
import ctypes
import importlib
import os
import re

import pytest
import torch

from recsys_tpu_torch.ops import cuda_build

#: the modules that declare the kernel sources
WRAPPERS = ("recsys_tpu_torch.ops.adam_update",
            "recsys_tpu_torch.ops.cin_kernel",
            "recsys_tpu_torch.ops.din_attention",
            "recsys_tpu_torch.ops.reshape_probe",
            "recsys_tpu_torch.ops.row_gather",
            "recsys_tpu_torch.ops.segment_sum",
            "recsys_tpu_torch.utils.profiling")
for _module in WRAPPERS:
    importlib.import_module(_module)


def _c_type(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    if "*" in param:
        return "pointer"
    for words, ctype in (("unsigned long long", ctypes.c_ulonglong),
                         ("long long", ctypes.c_longlong),
                         ("float", ctypes.c_float), ("int", ctypes.c_int)):
        if words in param:
            return ctype
    raise AssertionError(f"no ctypes type for {param!r}")


def _declared(ctype):
    if ctype is ctypes.c_void_p or (isinstance(ctype, type) and issubclass(
            ctype, ctypes._Pointer)):
        return "pointer"
    return ctype


@pytest.mark.parametrize("src", cuda_build.sources(),
                         ids=os.path.basename)
def test_each_source_declares_the_signatures_it_defines(src):
    signatures = cuda_build.signatures(src)
    assert signatures, f"no wrapper declares {src}"
    with open(src) as f:
        text = f.read()
    for name, args in signatures.items():
        m = re.search(rf"\bint {name}\(([^)]*)\)", text)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        assert [_c_type(p) for p in params] == [_declared(a) for a in args], \
            name


class _Lib:
    """A library whose entry point ``go`` records its arguments and
    returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def go(self, *args):
        self.calls.append(args)
        return self.err

    def kernel_error_string(self, err):
        return b"invalid argument"


@pytest.fixture
def stand_in_cuda(monkeypatch):
    """CUDA's device scope and current stream (handle 21) stood in for."""
    class Stream:
        cuda_stream = 21

    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())


def test_a_launch_calls_with_the_stream_last_and_counts(monkeypatch,
                                                        stand_in_cuda):
    lib = _Lib()
    monkeypatch.setattr(cuda_build, "load", lambda src: lib)
    with cuda_build.counting() as launches, \
            cuda_build.launch_tally(21) as tally:
        assert cuda_build.launch("x.cu", "go", "cuda:0", 1, 2.5) == 21
        cuda_build.launch("x.cu", "go", "cuda:0", 3, counter="other", n=4)
        cuda_build.launch("x.cu", "go", "cuda:0", n=0)
    assert lib.calls == [(1, 2.5, 21), (3, 21), (21,)]
    assert launches == tally == {"go": 1, "other": 4}


def test_a_refused_launch_raises_with_its_name_and_counts_nothing(
        monkeypatch, stand_in_cuda):
    monkeypatch.setattr(cuda_build, "load", lambda src: _Lib(err=1))
    with cuda_build.counting() as launches, \
            pytest.raises(RuntimeError, match="go launch failed: error 1 "
                                              r"\(invalid argument\)"):
        cuda_build.launch("x.cu", "go", "cuda:0")
    assert launches == {}


def test_recount_moves_the_registry_by_name():
    with cuda_build.counting() as launches:
        cuda_build.count("a", 5, 2)
        cuda_build.recount({"a": 2, "b": 3}, -1)
        cuda_build.recount({"b": 1})
    assert launches == {"b": -2}
    assert cuda_build.launches()["never counted"] == 0
