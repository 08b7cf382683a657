"""Multi-process bring-up of the port (mirroring
``tests/test_multiprocess.py``): ``recsys_tpu_torch.tools.mp_smoke``
workers, one OS process per rank, join a gloo process group through a file
store, shard input files disjointly, sum across processes, train through
the streaming SPMD driver, and run the counterpart of the JAX package's
``dryrun_multichip``."""

import json
import sys

import torch_dist_worker as W
from recsys_tpu_torch.core.config import CriteoConfig
from recsys_tpu_torch.data import criteo


def _mp_smoke(tmp_path, world: int, *flags, timeout: float = 240.0):
    store = tmp_path / "store"
    outs = W.launch(
        lambda r: [sys.executable, "-m", "recsys_tpu_torch.tools.mp_smoke",
                   f"--init_method=file://{store}", f"--world_size={world}",
                   f"--rank={r}", "--device=cpu", "--timeout_s=60", *flags],
        world, timeout)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def test_two_process_psum_and_file_sharding(tmp_path):
    outs = _mp_smoke(tmp_path, 2)
    for rank, rec in enumerate(outs):
        assert rec["ok"], rec
        assert rec["rank"] == rank and rec["world_size"] == 2
        assert rec["backend"] == "gloo"
        # both ranks see the global sum: 4·1 + 4·2
        assert rec["psum"] == rec["expected"] == 12.0
    shard0, shard1 = (set(r["file_shard"]) for r in outs)
    assert shard0.isdisjoint(shard1)
    assert shard0 | shard1 == {f"part-{i:02d}" for i in range(7)}
    assert abs(len(shard0) - len(shard1)) <= 1


def test_two_process_streaming_train_to_auc_floor(tmp_path):
    """Each rank streams ITS file shard through ShardSource →
    device_prefetch → train_and_evaluate_spmd_stream over a 2×1 mesh; both
    report the same eval AUC, above the floor."""
    small = CriteoConfig(cat_vocabs=tuple([200] * 6))
    data_dir, eval_dir = str(tmp_path / "train"), str(tmp_path / "eval")
    # 4 train shards (2 a rank), 2 eval shards (1 a rank)
    criteo.write_synthetic_shards(data_dir, 32_768, 4, small)
    criteo.write_synthetic_shards(eval_dir, 4_096, 2, small)
    outs = _mp_smoke(tmp_path, 2, "--mode=stream", f"--data_dir={data_dir}",
                     f"--eval_dir={eval_dir}",
                     f"--model_dir={tmp_path / 'm'}", "--num_steps=200",
                     timeout=360)
    shards = []
    for rec in outs:
        assert rec["ok"], rec
        assert rec["steps_done"] >= 200
        assert rec["auc"] > 0.58, rec
        shards.append(set(rec["file_shard"]))
    assert abs(outs[0]["auc"] - outs[1]["auc"]) < 1e-6
    assert shards[0].isdisjoint(shards[1])
    assert len(shards[0] | shards[1]) == 4
    assert (tmp_path / "m" / "step_200").exists()


def test_four_process_dryrun(tmp_path):
    """The dryrun on a 2×2 mesh: one SPMD step, a 3-step call and the
    sharded eval, the same loss and metrics on every rank."""
    outs = _mp_smoke(tmp_path, 4, "--mode=dryrun")
    for rec in outs:
        assert rec["ok"], rec
        assert rec["mesh"] == [2, 2]
        assert rec["loss_3_steps"] < rec["loss"]
    assert len({(r["loss"], r["loss_3_steps"], r["auc"]) for r in outs}) == 1
