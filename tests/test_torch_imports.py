"""The port stands alone: no module of ``recsys_tpu_torch`` (nor
``chip_smoke.py``) imports jax or the JAX package. Checked on the source
with ``ast``, since this interpreter may have jax loaded already."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "recsys_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_recsys_tpu_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "recsys_tpu"), (path, name)


def test_the_scan_sees_the_package():
    assert len(FILES) > 15
    for mod in ("models/din.py", "ops/row_gather.py", "data/amazon.py",
                "tools/train_din.py", "models/ctr.py", "ops/reshape_probe.py",
                "embeddings/engines.py", "train/optim.py",
                "serve/fastsock.py", "serve/numpy_engine.py",
                "train/summaries.py", "train/tb_events.py",
                "data/movielens.py", "models/vae_cf.py", "models/cdae.py",
                "train/vae_loop.py", "tools/train_vae.py",
                "extras/vi_gmm.py", "train/metrics.py",
                "data/synthetic_device.py", "models/ftrl_lr.py",
                "models/gbdt_lr.py", "models/jax_init.py",
                "core/jax_prng.py", "tools/converge.py", "tools/gbdt_fe.py",
                "tools/converge_study.py",
                "tools/results.py", "tools/bench_stream.py",
                "tools/bench_scaling.py", "utils/profiling.py"):
        assert ROOT / "recsys_tpu_torch" / mod in FILES, mod
    assert "torch" in set(_imports(ROOT / "recsys_tpu_torch" / "ops" /
                                   "cin_kernel.py"))
