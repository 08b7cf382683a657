"""What the innermost loops of hand-written kernels issue, from their SASS.

    python -m recsys_tpu_torch.tools.sass_loops [SOURCE.cu ...]

Builds each source (default: the package's ``csrc/cin_layer.cu``, the CIN
forward) with ``cuda_build`` and reads its library with
``cuobjdump -sass``. For each kernel function, of the loops that hold no
other loop, the one with the most FFMAs: its shared-memory loads
(``LDS*``), ``FFMA``, ``FMUL`` and all instructions, and the FFMA per LDS.
Prints one JSON line per source. Needs nvcc and cuobjdump (the CUDA
toolkit), not a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def inner_loops(sass: str) -> dict:
    """{kernel function: counts of its innermost loop with the most FFMAs}
    from ``cuobjdump -sass`` text. A loop is the span from a backward
    branch's target to the branch; innermost means no other loop lies
    inside it."""
    out = {}
    for chunk in sass.split("Function")[1:]:
        name = _FUNC.match("Function" + chunk).group(1)
        insns = [(int(a, 16), op, rest)
                 for a, op, rest in _INSN.findall(chunk)]
        loops = []
        for addr, op, rest in insns:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                loops.append((int(m.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any((c, d) != (a, b) and a <= c and d <= b
                            for c, d in loops)]
        best = None
        for a, b in inner:
            ops = [op for addr, op, _ in insns if a <= addr <= b]
            c = {"lds": sum(o.startswith("LDS") for o in ops),
                 "ffma": sum(o.startswith("FFMA") for o in ops),
                 "fmul": sum(o.startswith("FMUL") for o in ops),
                 "insns": len(ops)}
            if best is None or c["ffma"] > best["ffma"]:
                best = c
        if best:
            best["ffma_per_lds"] = best["ffma"] / max(best["lds"], 1)
            out[name] = best
    return out


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def main(argv: list[str] | None = None) -> list[dict]:
    from recsys_tpu_torch.ops import cin_kernel, cuda_build

    srcs = [os.path.abspath(a) for a in
            (sys.argv[1:] if argv is None else argv)] or [cin_kernel.SOURCE]
    results = []
    for src, lib in zip(srcs, cuda_build.build_all(srcs)):
        text = subprocess.run([_cuobjdump(), "-sass", lib],
                              capture_output=True, text=True,
                              check=True).stdout
        results.append({"source": os.path.relpath(src),
                        "inner_loops": inner_loops(text)})
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
