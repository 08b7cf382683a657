"""``tools/bench_stream.py`` of the port on the CPU at a tiny size: every
stage measures, the report lands at ``--out`` (never the working
directory's ``STREAMING.md``), and `pipeline_rates` (which
``chip_smoke.py`` reads) gives both rates and a batch's bytes."""

import json
import os

import numpy as np

from recsys_tpu_torch.data import criteo
from recsys_tpu_torch.data.loader import ShardSource
from recsys_tpu_torch.tools import bench_stream


def test_bench_stream_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_stream, "K", 2)    # devgen steps a call
    out = tmp_path / "reports" / "S.md"
    out.parent.mkdir()
    result = bench_stream.main([
        "--device=cpu", "--rows=2000", "--batch=128", "--train_steps=4",
        f"--workdir={tmp_path / 'w'}", f"--out={out}"])
    for key in ("s0_tsv_write_rows_per_s", "s1_preprocess_rows_per_s",
                "s2_host_pipeline_rows_per_s", "s3_h2d_rows_per_s",
                "s3_h2d_mb_per_s", "s4_stream_train_examples_per_s",
                "devgen_examples_per_s", "stream_vs_devgen"):
        assert result[key] > 0, (key, result)
    assert result["device_label"] == "cpu"
    text = out.read_text()
    assert "streaming training" in text and "on cpu" in text
    with open(tmp_path / "reports" / "S.json") as f:
        assert json.load(f)["batch"] == 128
    assert not os.path.exists(tmp_path / "STREAMING.md")
    assert len(list((tmp_path / "w" / "shards").glob("part-r-*.npz"))) == 1


def test_pipeline_rates_on_the_cpu(tmp_path):
    paths = criteo.write_synthetic_shards(str(tmp_path), 2048, 2)
    src = ShardSource(paths, 256, seed=0, num_epochs=-1)
    rates = bench_stream.pipeline_rates(src, "cpu", 4)
    assert rates["shard_source"] > 0 and rates["device_prefetch"] > 0
    with np.load(paths[0]) as z:
        want = 256 * sum(z[k].nbytes // len(z[k]) for k in z.files)
    assert rates["batch_bytes"] == want
