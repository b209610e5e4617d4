"""The trace reduction on a hand-made Chrome trace: device busy time as a
union, device ops charged to the host ranges open at their launch, calls
read back from their range names, idle gaps named by the host op."""

import pytest

from portbench import traces


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _events():
    return [
        _x("user_annotation", traces.WINDOW, 0.0, 1000.0),
        _x("user_annotation", "v3.factor", 10.0, 100.0),
        _x("user_annotation", f"{traces.CALL}:chol_batched:1x64x64:float32", 20.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 22.0, 2.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40.0, 2.0, correlation=2),
        _x("cpu_op", "aten::mm", 400.0, 400.0),
        _x("cuda_runtime", "cudaLaunchKernel", 510.0, 2.0, correlation=3),
        # two streams overlap between 200 and 250 us
        _x("kernel", "chol", 100.0, 150.0, tid=7, correlation=1),
        _x("kernel", "other", 200.0, 100.0, tid=8, correlation=2),
        _x("kernel", "gemm", 600.0, 100.0, tid=7, correlation=3),
        _x("gpu_user_annotation", "v3.factor", 100.0, 200.0, tid=7),
    ]


def test_busy_is_the_union_of_device_intervals():
    view = traces.TraceView(_events())
    assert view.window_s == pytest.approx(1e-3)
    assert view.busy_s == pytest.approx(300e-6)  # 100..300 and 600..700
    assert view.idle_pct() == pytest.approx(70.0)


def test_ops_are_charged_to_the_ranges_open_at_launch():
    view = traces.TraceView(_events())
    assert view.range_device_s("v3.factor") == pytest.approx(200e-6)
    assert view.range_device_s("v3.assemble") is None
    assert view.calls("chol_batched") == [(((1, 64, 64),), "float32", pytest.approx(150e-6))]


def test_breakdown_names_ops_and_gaps():
    b = traces.TraceView(_events()).breakdown()
    assert b["device_ops"][0] == ["chol", pytest.approx(150e-6)]
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(300e-6)  # 300..600, aten::mm open at 450
    assert gaps["v3.factor"] == pytest.approx(100e-6)  # 0..100, v3.factor open at 50
    assert gaps["host, outside any traced op"] == pytest.approx(300e-6)  # 700..1000


def test_a_trace_without_device_ops_reads_nothing():
    view = traces.TraceView([e for e in _events() if e["cat"] != "kernel"])
    assert view.idle_pct() is None and view.range_device_s("v3.factor") is None
    assert view.calls("chol_batched") == []
