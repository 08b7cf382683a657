"""Builds and loads the port's hand-written CUDA kernels and its host
library.

Each source under ``recsys_tpu_torch/csrc/`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` at first use, into
``recsys_tpu_torch/_build/`` under a name keyed by the source's hash, and
loaded with ctypes. A group of C++ sources (``.cc``: the repository's
``native/`` host data plane) is linked by ``g++`` into one library the same
way. Nothing is built when a module is imported.

Every kernel wrapper launches through this module alone:

- `source` names a ``.cu`` file with the C signatures of its entry points,
  which `load` sets on its first load;
- `launch` calls an entry point on a device's current stream, raises if
  the launch was refused, and counts it (`count`);
- the counts go to one process-wide registry of launches by counter name
  (`launches`, `counting`), and to the open `launch_tally` of the launch's
  stream, which is how a captured CUDA graph learns the launches its
  replays run (``train/step_graph.py``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: the C types of the entry points' arguments
P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: source path → {entry point: its C argument types} (`source`)
_signatures: dict[str, dict[str, list]] = {}
#: launches by counter name, and capturing stream handle → the launches
#: counted on it (`launch_tally`), both under ``_count_lock``
_launches: collections.Counter = collections.Counter()
_tallies: dict[int, collections.Counter] = {}
_count_lock = threading.Lock()


def source(name: str, **signatures: list) -> str:
    """Path of ``csrc/<name>``. ``signatures`` are the C argument types of
    its entry points by name (the stream last where there is one), each
    returning an int error; `load` sets them when it loads the library."""
    path = os.path.join(CSRC, name)
    if signatures:
        _signatures[path] = signatures
    return path


def signatures(src: str) -> dict[str, list]:
    """{entry point: its C argument types} that `source` declared for
    ``src``."""
    return dict(_signatures.get(src, {}))


def sources() -> list[str]:
    """Every kernel source, ``csrc/*.cu``, in name order."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    """nvcc of $CUDA_HOME, else the one on $PATH, else /usr/local/cuda's."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc is "
                       f"needed to build the kernels in {CSRC}")


def _files(src: str | tuple[str, ...]) -> tuple[str, ...]:
    return (src,) if isinstance(src, str) else tuple(src)


def library_path(src: str | tuple[str, ...]) -> str:
    """Where the library of ``src`` (one source, or a tuple of sources
    linked into one library) lives: named by the first source and keyed by
    the hash of every source's bytes."""
    h = hashlib.sha256()
    for path in _files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(_files(src)[0]))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _command(src: str | tuple[str, ...], out: str) -> list[str]:
    files = list(_files(src))
    if all(f.endswith(".cc") for f in files):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"no g++ on PATH to build {files}")
        return [gxx, "-O3", "-shared", "-fPIC", "-pthread", "-o", out] + files
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", out] + files


def build_all(sources: list) -> list[str]:
    """Compile every source that has no library yet, one compiler each, all
    started together; → library paths in the order given. A source is a
    ``.cu`` path (``nvcc``) or a tuple of ``.cc`` paths (``g++``, one
    library). The compiler's report (for ``nvcc``, ``-Xptxas -v``:
    registers, shared memory and spills of each kernel) is kept beside each
    library as ``<path>.log``. Each library is written to a temporary file
    and published with one rename, so a process that builds the same
    library at the same time, or loads it, never sees a partial file."""
    paths = [library_path(s) for s in sources]
    todo = [(s, p) for s, p in zip(sources, paths) if not os.path.exists(p)]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    try:
        for src, path in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = _command(src, tmp)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((cmd, proc, tmp, path))
        failed = []
        for cmd, proc, tmp, path in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(cmd[0])} failed "
                              f"({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{log}")
                continue
            with open(path + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, path)  # atomic publish: readers see all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(src: str) -> ctypes.CDLL:
    """The library of ``src``, built if needed and loaded once per process,
    its entry points typed as `source` declared them. Every library exports
    ``const char* kernel_error_string(int)``."""
    lib = _libs.get(src)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            lib = ctypes.CDLL(build_all([src])[0])
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for name, args in _signatures.get(src, {}).items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, ctypes.c_int
            _libs[src] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its launch was
    refused: too many threads, too much shared memory, bad arguments)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err} "
                           f"({lib.kernel_error_string(err).decode()})")


def launch(src: str, entry: str, device, *args, counter: str | None = None,
           n: int = 1) -> int:
    """Call the entry point ``entry`` of ``src``'s library with ``args`` and
    the current stream of the CUDA ``device`` (last), under that device;
    raise if it returns an error; count ``n`` launches under ``counter``
    (the entry's name by default). → the stream's handle."""
    import torch   # here: the host library's build needs no torch

    lib = load(src)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    check(lib, err, entry)
    count(counter or entry, stream, n)
    return stream


def count(counter: str, stream: int, n: int = 1) -> None:
    """Add ``n`` launches to ``counter`` in the registry and in the open
    tally of ``stream`` (the CUDA stream handle the launch went to), if it
    has one."""
    if not n:
        return
    with _count_lock:
        _launches[counter] += n
        tally = _tallies.get(stream)
        if tally is not None:
            tally[counter] += n


def recount(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` × ``counts`` ({counter: launches}) to the registry: a
    graph's capture takes its tally back (``times=-1``), each replay adds
    it again."""
    with _count_lock:
        for counter, n in counts.items():
            _launches[counter] += times * n


def launches() -> collections.Counter:
    """A copy of the registry: the launches counted so far in this process
    by counter name (a name never counted reads 0)."""
    with _count_lock:
        return collections.Counter(_launches)


@contextlib.contextmanager
def counting():
    """``with counting() as n:`` → ``n``, the launches counted inside the
    block by counter name (every thread's; the names that moved), filled
    when the block ends."""
    before = launches()
    moved: collections.Counter = collections.Counter()
    try:
        yield moved
    finally:
        after = launches()
        moved.update({k: after[k] - before[k] for k in after.keys() | before
                      if after[k] != before[k]})


@contextlib.contextmanager
def launch_tally(stream: int):
    """{counter name: launches} counted on ``stream`` inside the block, and
    only those: a graph capture learns its own launches (autograd's
    backward ones too, which another thread makes on the capturing stream)
    while other threads launch on other streams."""
    tally: collections.Counter = collections.Counter()
    with _count_lock:
        _tallies[stream] = tally
    try:
        yield tally
    finally:
        with _count_lock:
            del _tallies[stream]
