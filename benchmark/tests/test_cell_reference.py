"""The plain reference against the port's eager path on the CPU, at a tiny
size: a whole run of a tiny cell (set-up, window, comparison) comes out
correct, and the reference draws each step's rows and masks as the port's
generator does."""

import pytest
import torch

from benchmark import draws, reference, run
from recsys_tpu_torch.train import train_state as TS


@pytest.mark.parametrize("model", ["deepfm", "xdeepfm"])
def test_a_tiny_cell_is_correct_on_the_cpu(tiny_cell, model):
    cell = tiny_cell(model)
    result = run.run_cell(cell, 2 ** 31 + 77, 0.2, False,
                          torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_examples_per_s", "setup_s"}
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5, 2 ** 40 + 3])
def test_step_seeds_are_the_ports(seed):
    for step in (0, 1, 2, 53, 10 ** 6):
        assert draws.step_seed(seed, step) == TS.step_seed(seed, step)


def test_the_reference_draws_the_ports_rows_and_masks(tiny_cell):
    cell = tiny_cell("deepfm")
    config, traffic = cell["config"], cell["traffic"]
    seed, step, n = 2 ** 33 + 1, 2, 3000
    ts = TS.TrainState({}, {}, None, torch.zeros(()),
                       TS.make_generator(seed + 1, "cpu"), seed)
    TS.reseed(ts, step)
    idx = torch.empty(traffic["batch"], dtype=torch.int64)
    idx.random_(0, n, generator=ts.rng)          # as fast.py's devgen step
    first = torch.rand((traffic["batch"], 100), generator=ts.rng) < 0.5
    ref_idx, masks = reference.batch_draws(config, traffic, seed, step, n,
                                           "cpu")
    assert torch.equal(idx, ref_idx) and torch.equal(first, masks[0])


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -12])
    assert reference.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10,
                                             1.0 + 2 ** -10,
                                             -3.0 - 2 ** -9]
