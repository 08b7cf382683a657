"""What ``correct`` catches: a run of a tiny cell on the CPU, with the
timed path broken underneath (the harness's look for a card skipped, the
rest of the run as it is), comes out not correct for each fault a one-chip
training cell can have, and for faults confined to the leaves that the
embedding and CIN kernels serve; and the control, the reference in the
port's place in TF32, fails a number that the port's own readings pass."""

import pytest
import torch

from benchmark import control, port, run
from recsys_tpu_torch.ops import cin_kernel, segment_sum
from recsys_tpu_torch.train import optim
from recsys_tpu_torch.train import train_state as TS


def _unchanged_state(monkeypatch, cell):
    """Adam's update returns the state as it was."""
    real = optim.adam

    def adam(*args, **kwargs):
        opt = real(*args, **kwargs)
        return opt._replace(update=lambda grads, state, params:
                            (params, state))

    monkeypatch.setattr(optim, "adam", adam)


def _half_batch(monkeypatch, cell):
    """The loss is the mean over the first half of the batch."""
    real = TS.sigmoid_ce
    monkeypatch.setattr(TS, "sigmoid_ce",
                        lambda logits, labels: real(logits[:len(logits) // 2],
                                                    labels[:len(labels) // 2]))


def _tables_unchanged(monkeypatch, cell):
    """Adam's update leaves the embedding tables, and their moments, as
    they were; every other leaf steps."""
    real = optim.adam

    def adam(*args, **kwargs):
        opt = real(*args, **kwargs)

        def update(grads, state, params):
            kept = [(t, t.clone()) for tree in (params, state.mu, state.nu)
                    for t in tree["tables"].values()]
            out = opt.update(grads, state, params)
            for t, was in kept:
                t.copy_(was)
            return out

        return opt._replace(update=update)

    monkeypatch.setattr(optim, "adam", adam)


def _big_table_sum_doubled(monkeypatch, cell):
    """The segment sum of the big table's gradient (K1) hands back twice
    the sum; the small table's (K2) is right."""
    template, _ = port.templates(port.model(cell["config"]))
    rows = template["tables"]["big"].shape[0]
    real = segment_sum.segment_sum

    def doubled(ids, grads, num_rows):
        out = real(ids, grads, num_rows)
        return 2.0 * out if num_rows == rows else out

    monkeypatch.setattr(segment_sum, "segment_sum", doubled)


def _cin_filter_grad_scaled(monkeypatch, cell):
    """K3b hands back its filters' gradient 1.5 times too large."""
    real = cin_kernel.cin_layer_bwd

    def scaled(*args):
        dx0, dxk, dw, db = real(*args)
        return dx0, dxk, 1.5 * dw, db

    monkeypatch.setattr(cin_kernel, "cin_layer_bwd", scaled)


@pytest.mark.parametrize("fault, model", [
    (_unchanged_state, "deepfm"), (_unchanged_state, "xdeepfm"),
    (_half_batch, "deepfm"), (_half_batch, "xdeepfm"),
    (_tables_unchanged, "deepfm"), (_tables_unchanged, "xdeepfm"),
    (_big_table_sum_doubled, "deepfm"), (_big_table_sum_doubled, "xdeepfm"),
    (_cin_filter_grad_scaled, "xdeepfm")])
def test_a_broken_step_is_not_correct(tiny_cell, monkeypatch, fault, model):
    cell = tiny_cell(model)
    fault(monkeypatch, cell)
    result = run.run_cell(cell, 99, 0.1, False, torch.device("cpu"))
    assert not result["correct"], result["checks"]


def test_the_control_fails_where_the_port_passes(tiny_cell):
    cell = tiny_cell("deepfm")
    limits = cell["limits"]
    for seed in (3, 4, 5):
        r = control.readings(cell, seed, torch.device("cpu"))
        assert all(r["program"][k] <= limits[k]["limit"] for k in limits
                   if not k.startswith("_"))
        assert any(r["control"][k] > limits[k]["limit"] for k in limits
                   if not k.startswith("_"))
        assert any(r["half_batch"][k] > limits[k]["limit"] for k in limits
                   if not k.startswith("_"))
