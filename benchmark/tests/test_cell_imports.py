"""Nothing the benchmark runs on the card imports JAX or the JAX package,
and its reference imports nothing of the port either. Each module's
top-level name is compared whole: ``recsys_tpu_torch`` begins with
``recsys_tpu`` and is not it."""

import ast
import glob
import os
import sys

import pytest

from benchmark import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "recsys_tpu"}
OWN = ("benchmark", "recsys_tpu_torch")


def _imports(path: str) -> set[str]:
    """Every module a file imports, anywhere in it, by full name."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def _file(module: str) -> str | None:
    base = os.path.join(spec.ROOT, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


def _walk(paths) -> dict[str, set[str]]:
    """{file: its imports} of ``paths`` and of every module of the repo's
    own packages that they import, transitively."""
    seen, todo = {}, list(paths)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = _imports(path)
        for name in seen[path]:
            if name.split(".")[0] in OWN:
                parts = name.split(".")
                for i in range(1, len(parts) + 1):   # packages on the way
                    f = _file(".".join(parts[:i]))
                    if f is not None and f not in seen:
                        todo.append(f)
    return seen


def _chip_roots():
    here = spec.HERE
    return ([os.path.join(here, f) for f in ("run.py", "control.py")]
            + glob.glob(os.path.join(here, "kinds", "*.py"))
            + glob.glob(os.path.join(here, "metrics", "*.py"))
            + glob.glob(os.path.join(here, "models", "*.py")))


def _reference_roots():
    here = spec.HERE
    return ([os.path.join(here, "reference.py")]
            + glob.glob(os.path.join(here, "models", "*.py")))


def test_the_chip_path_imports_no_jax():
    walked = _walk(_chip_roots())
    assert any("recsys_tpu_torch" in f for f in walked), \
        "the walk should reach the port"
    bad = {f: sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
           for f, names in walked.items()}
    assert not any(bad.values()), {f: b for f, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_port():
    walked = _walk(_reference_roots())
    bad = {f: sorted(n for n in names
                     if n.split(".")[0] in FORBIDDEN | {"recsys_tpu_torch"})
           for f, names in walked.items()}
    assert not any(bad.values()), {f: b for f, b in bad.items() if b}


@pytest.mark.parametrize("loaded, found", [
    (["recsys_tpu_torch", "recsys_tpu_torch.train"], []),
    (["recsys_tpu.models"], ["recsys_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["jaxtyping", "flaxen"], []),
])
def test_the_run_names_what_it_finds_loaded(monkeypatch, loaded, found):
    modules = {k: v for k, v in sys.modules.items()
               if k.split(".")[0] not in FORBIDDEN}
    modules.update({name: None for name in loaded})
    monkeypatch.setattr(sys, "modules", modules)
    assert run.forbidden_modules() == found
