"""Adam's update over a list of leaves (``recsys_tpu_torch/ops/adam_update.py``)
on the CPU: the wrapper's checks, ``optim.adam``'s update bitwise equal to
the loop it ran before the kernel (kept below as the witness), and the
kernel source's note. On the CPU the wrapper takes its plain version; the
CUDA kernel runs only on a card, where tests/test_torch_gpu.py holds it
bitwise against the plain version.
"""

import os

import pytest
import torch

from recsys_tpu_torch.ops import adam_update as au
from recsys_tpu_torch.ops import cuda_build
from recsys_tpu_torch.train import optim

SHAPES = [(300, 17), (4099,), (24, 10), (), (1,), (10,)]


def _tree(seed, shapes=SHAPES):
    gen = torch.Generator().manual_seed(seed)
    mu = [1e-3 * torch.randn(s, generator=gen) for s in shapes]
    return ([0.05 * torch.randn(s, generator=gen) for s in shapes],
            [1e-2 * torch.randn(s, generator=gen)
             * (torch.rand(s, generator=gen) < 0.3) for s in shapes],
            mu, [m * m + (1e-3 * torch.randn(s, generator=gen)) ** 2
                 for s, m in zip(shapes, mu)])


def _loop_as_it_stood(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=0.0):
    """``optim.adam``'s update before the kernel: a chain of eager
    operations a leaf."""

    @torch.no_grad()
    def update(grads, state, params):
        state.count.add_(1)
        t = state.count.to(torch.float32)
        lr = learning_rate(t) if callable(learning_rate) else learning_rate
        lr_t = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            decay = lr * weight_decay * p if weight_decay else None
            p.sub_(lr_t * m / (v.sqrt() + eps))
            if decay is not None:
                p.sub_(decay)
        return params, state

    return update


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_update_is_the_loop_as_it_stood_bitwise(schedule, weight_decay):
    """Six steps of ``optim.adam(...).update`` on CPU tensors: parameters,
    moments and step count bitwise those of the loop it replaced, with and
    without a schedule (its warm-up ends inside) and weight decay; the
    update returns the objects it was given."""
    lr = (optim.cosine_decay(1e-2, 6, warmup_steps=2)
          if schedule == "cosine" else 1e-2)
    runs = []
    for update in (optim.adam(lr, weight_decay=weight_decay).update,
                   _loop_as_it_stood(lr, weight_decay=weight_decay)):
        p, g, m, v = (list(x) for x in _tree(0))
        state = optim.AdamState(torch.zeros((), dtype=torch.int32), m, v)
        for s in range(6):
            out = update([gi * (1.0 + 0.5 * s) for gi in g], state, p)
            assert out[0] is p and out[1] is state
        runs.append((p, m, v, state.count))
    (p1, m1, v1, c1), (p2, m2, v2, c2) = runs
    assert int(c1) == int(c2) == 6
    for a, b in zip(p1 + m1 + v1, p2 + m2 + v2, strict=True):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version_without_counting():
    tree = _tree(1)
    want = [[t.clone() for t in leaves] for leaves in tree]
    lr_t = torch.tensor(1e-3)
    with cuda_build.counting() as launches:
        au.adam_update(*tree, lr_t, None, 0.9, 0.999, 1e-8)
    au.adam_update_reference(*want, lr_t, None, 0.9, 0.999, 1e-8)
    for a, b in zip(sum(tree, []), sum(want, []), strict=True):
        assert torch.equal(a, b)
    assert (launches["adam_update"], launches["adam_update.leaves"]) == (0, 0)
    au.adam_update([], [], [], [], lr_t, None, 0.9, 0.999, 1e-8)   # no leaf


def _bad_tree(kind):
    p, g, m, v = (list(x) for x in _tree(2))
    if kind == "mixed devices":
        v[1] = torch.empty(v[1].shape, device="meta")
    elif kind == "float64 leaf":
        m[0] = m[0].double()
    elif kind == "non-contiguous leaf":
        g[2] = torch.zeros(10, 24).t()
    elif kind == "mismatched sizes":
        v[3] = torch.zeros(2)
    elif kind == "lists of other lengths":
        g = g[:-1]
    return p, g, m, v


@pytest.mark.parametrize("kind,error", [
    ("mixed devices", ValueError), ("float64 leaf", TypeError),
    ("non-contiguous leaf", ValueError), ("mismatched sizes", ValueError),
    ("lists of other lengths", ValueError)])
def test_checks_raise(kind, error):
    with pytest.raises(error):
        au.adam_update(*_bad_tree(kind), torch.tensor(1e-3), None, 0.9,
                       0.999, 1e-8)


def test_no_kernel_for_other_devices():
    tree = [[torch.empty(3, device="meta")] for _ in range(4)]
    with pytest.raises(ValueError, match="no kernel"):
        au.adam_update(*tree, 1e-3, None, 0.9, 0.999, 1e-8)


def test_the_kernel_source_carries_its_note():
    """The source says that it replaces no TPU kernel and why it was added,
    what bounds it on the card and how its design answers."""
    with open(au.SOURCE) as f:
        head = f.read().split("#include")[0]
    assert os.path.basename(au.SOURCE) == "adam_update.cu"
    for words in ("replaces no TPU kernel", "What bounds it on the H100: bytes",
                  "28 bytes", "0.120 ms at 3.35 TB/s", "MAX_LEAVES",
                  "float4", "no atomics", "bitwise"):
        assert words in head, words
    assert f"MAX_LEAVES = {au.MAX_LEAVES};" in open(au.SOURCE).read()


def test_a_tally_adds_a_count_of_launches():
    """A wrapper that counts several launches (or leaves) at once adds
    them to the registry and to the open tally of its stream in one call."""
    with cuda_build.counting() as launches, \
            cuda_build.launch_tally(11) as tally:
        cuda_build.count("adam_update.leaves", 11, 15)
        cuda_build.count("adam_update", 11)
    assert tally == launches == {"adam_update.leaves": 15, "adam_update": 1}
