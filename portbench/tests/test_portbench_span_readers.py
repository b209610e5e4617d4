"""The readers of the program's span tree on a hand-made Chrome trace:
launches counted by name inside a span, device idle split by the outermost
layer span open, and a share of span instances."""

import pytest

from portbench import traces
from portbench.readers import span_idle, span_launches, span_share

LAYERS = ["v3.assemble", "v3.factor", "v3.backsolve", "v3.update"]
SOLVE = (100.0, 900.0)
# per iteration: assemble, factor (v3.separator nested), backsolve, update
ITERATIONS = [(100.0, 500.0), (500.0, 880.0)]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _layer_spans():
    out = []
    for a, _ in ITERATIONS:
        out += [("v3.assemble", a + 10, a + 100), ("v3.factor", a + 100, a + 250),
                ("v3.separator", a + 150, a + 200), ("v3.backsolve", a + 250, a + 300),
                ("v3.update", a + 300, a + 370)]
    return out


DEVICE = [(50.0, 120.0), (105.0, 130.0),  # two streams overlap across assemble's start
          (230.0, 380.0), (390.0, 400.0), (590.0, 640.0), (860.0, 950.0)]


def _events(with_solve=True):
    ev = [_x("user_annotation", traces.WINDOW, 0.0, 1000.0)]
    if with_solve:
        ev.append(_x("user_annotation", "v3.solve", SOLVE[0], SOLVE[1] - SOLVE[0]))
    for a, b in ITERATIONS:
        ev.append(_x("user_annotation", "v3.iteration", a, b - a))
    for name, a, b in _layer_spans():
        ev.append(_x("user_annotation", name, a, b - a))
    for k, (s, e) in enumerate(DEVICE):
        ev.append(_x("kernel", f"k{k}", s, e - s, tid=7, correlation=100 + k))
    # host calls: inside the first iteration 3 launches, a copy, a memset, a
    # graph launch, two synchronisations and an event record; inside the
    # second one launch; one launch outside any iteration and one on another thread
    calls = [("cudaLaunchKernel", 120.0), ("cuLaunchKernelEx", 160.0),
             ("cudaLaunchKernelExC", 170.0), ("cudaMemcpyAsync", 210.0),
             ("cudaMemsetAsync", 220.0), ("cudaGraphLaunch", 260.0),
             ("cudaStreamSynchronize", 270.0), ("cudaDeviceSynchronize", 280.0),
             ("cudaEventRecord", 290.0), ("cudaLaunchKernel", 600.0),
             ("cudaLaunchKernel", 890.0)]
    for k, (name, t) in enumerate(calls):
        ev.append(_x("cuda_runtime", name, t, 1.0, correlation=k + 1))
    ev.append(_x("cuda_runtime", "cudaLaunchKernel", 150.0, 1.0, tid=2, correlation=99))
    return ev


def _brute_force():
    """Idle microseconds of each part, sampled at every half microsecond."""
    out = dict.fromkeys([*LAYERS, "glue", "outside"], 0.0)
    spans = _layer_spans()
    for k in range(1000):
        t = k + 0.5
        if any(s <= t < e for s, e in DEVICE):
            continue
        if not SOLVE[0] <= t < SOLVE[1]:
            out["outside"] += 1.0
            continue
        open_ = [name for name, a, b in spans if a <= t < b and name in LAYERS]
        out[open_[0] if open_ else "glue"] += 1.0
    return out


def test_launches_are_counted_by_name_inside_the_span():
    view = traces.TraceView(_events())
    # first iteration: 3 launches + copy + memset + graph launch = 6; second: 1
    assert span_launches.read(view, 2, span="v3.iteration") == pytest.approx(3.5)
    assert span_launches.enqueues("cudaGraphLaunch")
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventRecord",
                 "cudaEventQuery", "cudaLaunchHostFunc", "cudaStreamWaitEvent"):
        assert not span_launches.enqueues(name), name


def test_idle_is_split_by_the_outermost_layer():
    view = traces.TraceView(_events())
    want = _brute_force()
    parts = span_idle.split(view, "v3.solve", LAYERS)
    for k, v in want.items():
        assert parts[k] == pytest.approx(v * 1e-6), k
    # by hand: v3.factor is idle 200..230 in the first iteration and 640..750
    # in the second; the nested v3.separator (250..300) counts in v3.factor
    assert want["v3.factor"] == 30.0 + 110.0
    for part in [*LAYERS, "glue"]:
        got = span_idle.read(view, 2, solve="v3.solve", layers=LAYERS, part=part)
        assert got == pytest.approx(1e3 * want[part] * 1e-6 / 2)


def test_idle_parts_sum_to_the_stretch_idle():
    view = traces.TraceView(_events())
    parts = span_idle.split(view, "v3.solve", LAYERS)
    assert sum(parts.values()) == pytest.approx(view.idle_pct() / 100.0 * view.window_s)
    five = sum(span_idle.read(view, 2, solve="v3.solve", layers=LAYERS, part=p)
               for p in [*LAYERS, "glue"])
    assert five * 2 * 1e-3 + parts["outside"] == pytest.approx(
        view.idle_pct() / 100.0 * view.window_s)


def _lm_events(outcomes):
    ev = [_x("user_annotation", traces.WINDOW, 0.0, 1000.0),
          _x("kernel", "k", 10.0, 10.0, tid=7, correlation=1)]
    for k, name in enumerate(outcomes):
        ev.append(_x("user_annotation", name, 100.0 + 10 * k, 1.0))
    ev.append(_x("user_annotation", "ba.lm_accept", 2000.0, 1.0))  # after the stretch
    return ev


def test_accept_share():
    view = traces.TraceView(_lm_events(["ba.lm_accept"] * 3 + ["ba.lm_reject"]))
    among = ["ba.lm_accept", "ba.lm_reject"]
    assert span_share.read(view, 4, span="ba.lm_accept", among=among) == pytest.approx(75.0)
    assert span_share.read(view, 4, span="ba.lm_reject", among=among) == pytest.approx(25.0)


@pytest.mark.parametrize("reader, params", [
    (span_launches, {"span": "v3.iteration"}),
    (span_idle, {"solve": "v3.solve", "layers": LAYERS, "part": "v3.factor"}),
    (span_idle, {"solve": "v3.solve", "layers": LAYERS, "part": "glue"}),
    (span_share, {"span": "ba.lm_accept", "among": ["ba.lm_accept", "ba.lm_reject"]}),
])
def test_no_span_reads_nothing(reader, params):
    # the program without the span tree: no v3.solve, no v3.iteration, no LM spans
    ev = [e for e in _events(with_solve=False) if e["name"] != "v3.iteration"]
    assert reader.read(traces.TraceView(ev), 2, **params) is None
    # no device op at all
    ev = [e for e in _events() if e["cat"] != "kernel"]
    if reader is not span_share:
        assert reader.read(traces.TraceView(ev), 2, **params) is None
