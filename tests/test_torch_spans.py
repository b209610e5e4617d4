"""The port's profiler spans (``utils/spans.py``): the tree a v3 solve and a
BA LM solve open under ``torch.profiler``, the shared LM loop
(``solvers/lm.lm_loop``) on a scripted step, and the gate that keeps every
span out of ``record_function`` while no profiler runs."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from slampp_tpu_torch.apps import manhattan
from slampp_tpu_torch.apps.sphere import sphere_system
from slampp_tpu_torch.io.datasets import make_venice_ba_arrays
from slampp_tpu_torch.linear import ba_schur
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.solvers.lm import lm_loop
from slampp_tpu_torch.utils import spans

torch.set_num_threads(1)
BA_LAYERS = ["ba.jacobians", "ba.landmarks", "ba.pairs", "ba.sc_build", "ba.sc_factor",
             "ba.backsub"]


def _tree(prof, prefix):
    """The spans whose names start with ``prefix`` as nested [name, children],
    a child being a span that opens and closes inside its parent."""
    evs = sorted((e.start_ns(), -e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation() and e.name().startswith(prefix))
    root = []
    stack = [(float("inf"), root)]
    for start, neg_end, name in evs:
        while stack[-1][0] < -neg_end:
            stack.pop()
        node = [name, []]
        stack[-1][1].append(node)
        stack.append((-neg_end, node[1]))
    return root


def _names(nodes):
    return [n for n, _ in nodes]


def _v3_solver(mixed, dense_frames):
    ps = PartitionedSolver(sphere_system(50), target=16, mixed_precision=mixed, device="cpu")
    ps.symbolic()
    if dense_frames:
        ps.plan = ps.plan._replace(ch_ok=0)
    return ps, ps.system.snapshot("cpu")


def _ba_solver():
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(n_cams=8, n_points=150,
                                                           mean_track=4, seed=0)
    solver = ba_schur.BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, device="cpu")
    solver.steps = 0
    step = solver.step

    def counted(*args):
        solver.steps += 1
        return step(*args)

    solver.step = counted
    return solver


@pytest.mark.parametrize("dense_frames", [False, True], ids=["chain", "dense"])
@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "f64"])
def test_v3_solve_opens_one_tree(mixed, dense_frames):
    ps, graph = _v3_solver(mixed, dense_frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ps.optimize_fused(graph, n_iters=3)
    tree = _tree(prof, "v3.")
    assert _names(tree) == ["v3.solve"]
    iterations = tree[0][1]
    assert _names(iterations) == ["v3.iteration"] * 3
    for _, layers in iterations:
        assert _names(layers) == ["v3.assemble", "v3.factor", "v3.backsolve", "v3.update"]
        factor = dict((n, c) for n, c in layers)["v3.factor"]
        assert set(_names(factor)) <= {"v3.separator"}


def test_ba_solve_opens_one_tree():
    solver = _ba_solver()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        accepted = solver.optimize(max_iterations=4, min_dx_norm=0.0)
    tree = _tree(prof, "ba.")
    assert _names(tree) == ["ba.solve"]
    passes = tree[0][1]
    assert _names(passes) == ["ba.chi2"] + ["ba.iteration"] * solver.steps
    assert solver.steps == 4
    outcomes = []
    for _, inner in passes[1:]:
        names = _names(inner)
        assert names[:7] == BA_LAYERS + ["ba.chi2"]
        assert len(names) == 8 and names[7] in ("ba.lm_accept", "ba.lm_reject")
        outcomes.append(names[7])
    assert outcomes.count("ba.lm_accept") == accepted


def test_a_rejected_step_opens_lm_reject():
    solver = _ba_solver()
    step = solver.step

    def worse(*args):  # moves every point 10 m: chi2 rises, the gain test rejects
        nc, nl, dxn, chi2, denom = step(*args)
        return nc, nl + 10.0, dxn, chi2, denom

    solver.step = worse
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        accepted = solver.optimize(max_iterations=2, min_dx_norm=0.0)
    passes = _tree(prof, "ba.")[0][1][1:]
    assert accepted == 0
    assert [_names(inner)[-1] for _, inner in passes] == ["ba.lm_reject"] * 2


# (chi2 of the candidate, gain denominator, |dx|) of each scripted step from
# chi2 100: accept at rho 0.75 (alpha *= 1 - 0.5^3), two rejects (nu 2, then
# 4), accept at rho 0.5 (alpha kept, nu back to 2), accept at rho 1.5 (the
# 1/3 floor), reject (nu 2), then a step that is not finite
SCRIPT = [(70.0, 40.0, 1.0), (80.0, 10.0, 1.0), (75.0, 10.0, 1.0), (60.0, 20.0, 1.0),
          (30.0, 20.0, 1.0), (40.0, 20.0, 1.0), (0.0, 1.0, float("nan"))]


@pytest.mark.parametrize("names", [("ba.iteration", "ba.lm_accept", "ba.lm_reject"),
                                   ("lm.iteration", "lm.accept", "lm.reject"), None],
                         ids=["ba", "lm", "none"])
def test_lm_loop_on_a_scripted_step(names, capsys):
    alphas = []

    def step(state, alpha):
        alphas.append(alpha)
        chi2, denom, dxn = SCRIPT[len(alphas) - 1]
        return (len(alphas), chi2), denom, dxn

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = lm_loop((0, 100.0), step, lambda s: s[1], 1.0, 10, 0.0, names,
                      "{it} {verdict} {chi2} {alpha!r}")
    assert alphas == pytest.approx([1.0, 0.875, 1.75, 7.0, 7.0, 7.0 / 3.0, 14.0 / 3.0],
                                   rel=1e-15)
    assert out == ((5, 30.0), 3, 7, "not_finite")
    lines = [ln.split() for ln in capsys.readouterr().out.splitlines()]
    assert [ln[:3] for ln in lines] == [
        ["1", "accepted", "70.0"], ["2", "rejected", "80.0"], ["3", "rejected", "75.0"],
        ["4", "accepted", "60.0"], ["5", "accepted", "30.0"], ["6", "rejected", "40.0"]]
    assert [float(ln[3]) for ln in lines] == alphas[1:]
    tree = _tree(prof, ("ba.", "lm."))
    if names is None:
        assert tree == []
        return
    it, accept, reject = names
    assert _names(tree) == [it] * 7
    assert [_names(inner) for _, inner in tree] == [
        [accept], [reject], [reject], [accept], [accept], [reject], []]


def test_no_profiler_no_record_function(monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    ps, graph = _v3_solver(False, True)
    solver = _ba_solver()
    ps.optimize_fused(graph, n_iters=2)
    solver.optimize(max_iterations=2, min_dx_norm=0.0)
    assert entered == []
    # the same patch sees every span once a profiler runs
    with profile(activities=[ProfilerActivity.CPU]):
        ps.optimize_fused(graph, n_iters=2)
        solver.optimize(max_iterations=2, min_dx_norm=0.0)
    assert entered.count("v3.solve") == 1 and entered.count("v3.iteration") == 2
    assert entered.count("ba.solve") == 1 and entered.count("ba.iteration") == 2
    assert entered.count("ba.chi2") == 3


def test_span_is_shared_null_context_when_off():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("a") is not spans.span("a")


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0.0, 10.0), (5.0, 20.0)], 20.0),  # two streams overlap: counted once
    ([(0.0, 10.0), (2.0, 3.0), (30.0, 40.0)], 20.0),
])
def test_profile_busy_is_a_union(intervals, busy):
    assert manhattan._union_us(intervals) == pytest.approx(busy)


def test_profile_layers_pick_up_the_tree():
    ps, graph = _v3_solver(False, True)
    out = manhattan._profiled(lambda: float(ps.optimize_fused(graph, n_iters=2)[3]),
                              torch.device("cpu"), top=5)
    assert out["layers"]["v3.solve"]["count"] == 1
    assert out["layers"]["v3.iteration"]["count"] == 2
    assert out["layers"]["v3.factor"]["count"] == 2
    assert out["device_busy_us"] == 0.0 and out["device_idle_share"] == 1.0
