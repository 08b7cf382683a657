"""The reduction of a traced slice to the per-layer metrics and the
breakdown, on a summary made by hand."""

import pytest

from benchmark import spec, trace

K = 2     # steps in the slice


def _summary():
    device = [("row_gather_kernel<float>", 0.0, 10.0),
              ("DeviceRadixSortOnesweepKernel", 10.0, 30.0),
              ("gemm", 30.0, 100.0),
              ("cin_fwd_kernel<20>", 150.0, 170.0),
              ("gemm", 160.0, 200.0)]             # overlaps the one above
    host = [("cudaGraphLaunch", 0.0, 5.0), ("cudaGraphLaunch", 105.0, 110.0),
            ("cudaLaunchKernel", 110.0, 111.0), ("aten::div", 100.0, 140.0)]
    s = trace.summarize(device, host, 250e-6, K)
    s.update(examples_per_s=1e6, flops_per_example=1e6,
             work={"embedding": [(3.35e6, 0.0)], "cin": [(0.0, 67e6)]})
    return s


def test_union_counts_overlaps_once():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert _summary()["busy_s"] == pytest.approx(150e-6)


@pytest.mark.parametrize("metric, value", [
    ("host_launches_per_step.train", 3 / K),
    ("step_device_ms.train", 150e-3 / K),
    ("device_idle.train", 100 * (1 - 150 / 250)),
    ("mfu.train", 100 * 3e12 / 67e12),
    # a bound of 1 µs a step, 2 steps, against 30 µs of the gather and sort
    ("embedding_roofline", 100 * 2e-6 / 30e-6),
    ("cin_roofline", 100 * 2e-6 / 20e-6),
])
def test_readers(metric, value):
    assert spec.metric_reader(metric)(_summary()) == pytest.approx(value)


def test_a_roofline_reader_finds_nothing_without_its_kernels():
    s = _summary()
    s["device_ops"] = [op for op in s["device_ops"] if "cin" not in op[0]]
    assert spec.metric_reader("cin_roofline")(s) is None


def test_breakdown():
    b = trace.breakdown(_summary())
    assert b["device_ops"][0] == ["gemm", pytest.approx(110e-6)]
    # the card idles from 100 to 150 µs, under the host's division
    assert b["idle_gaps"][0] == ["aten::div", pytest.approx(50e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
