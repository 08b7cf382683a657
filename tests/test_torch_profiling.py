"""`utils/profiling.py` on a small training step on the CPU: the trace's
operations summed by name (on the CPU their own time, so a parent is not
counted twice), each with the place in the port's code that launched it,
and the Chrome trace written where asked."""

import json

import numpy as np

from recsys_tpu_torch.core.config import CriteoConfig, ModelConfig
from recsys_tpu_torch.data.criteo import synthetic_criteo
from recsys_tpu_torch.models.api import make_model
from recsys_tpu_torch.train import fast
from recsys_tpu_torch.train import train_state as TS
from recsys_tpu_torch.utils import profiling

CFG = CriteoConfig(cat_vocabs=(50,) * 20 + (3000,) * 6)


def _step():
    model = make_model("deepfm", CFG, ModelConfig(
        name="deepfm", embedding_dim=4, deep_layers=(8, 8)))
    ts, tx = TS.create_train_state(model, 0, 1e-3, "cpu")
    batch = fast.stage_dataset(synthetic_criteo(256, CFG), "cpu")
    step = TS.make_train_step(model, tx)
    return lambda: step(ts, batch)


def test_breakdown_of_a_cpu_step(tmp_path, capsys):
    prof = profiling.trace_step(_step(), trace_dir=str(tmp_path / "t"))
    rows = profiling.device_breakdown(prof, top=None)
    assert rows and all(r["device"] == "cpu" for r in rows)
    ms = [r["total_ms"] for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    names = {r["op"] for r in rows}
    assert "aten::addmm" in names or "aten::mm" in names
    top = profiling.device_breakdown(prof, top=5)
    assert top == rows[:5]
    # own times: no operation's exceeds the traced span
    wall_ms = max(e.time_range.end for e in prof.events()) / 1e3
    assert ms[0] <= wall_ms
    rows = profiling.annotate_with_source(rows, prof)
    sources = [r["source"] for r in rows if r["source"]]
    assert any("recsys_tpu_torch" in s and ".py(" in s for s in sources)
    mm = [r for r in rows if r["op"] in ("aten::addmm", "aten::mm")]
    assert any(r["source"] and "recsys_tpu_torch" in r["source"]
               for r in mm)
    with open(tmp_path / "t" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    profiling.print_breakdown(rows[:3])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and " ms " in out[0]


def test_card_names_the_cpu():
    assert profiling.card("cpu") == "cpu"


def test_device_time_us_reads_either_attribute():
    class New:
        self_device_time_total = 12.5

    class Old:
        self_cuda_time_total = 3

    assert profiling.device_time_us(New()) == 12.5
    assert profiling.device_time_us(Old()) == 3.0
    assert np.isclose(profiling.device_time_us(object()), 0.0)
