"""The observation-driven BA Schur solver of slampp_tpu_torch
(``linear/ba_schur.py``) against the JAX package's on
``make_venice_ba_arrays(n_cams=12, n_points=400, mean_track=5)``: the plan's
arrays equal (observations, segment groups, the device-made pair table and
its buckets, the SC block map); one ``ba_schur_lm_step`` in float64 (SC and
pair products) within 1e-8; ``BigBASolver.optimize`` with the same accepted
steps and chi2 within 1e-8 in float64 and 5e-3 with the float32 SC; the
plan of a parsed BA graph equal to the one from its arrays; and LM's
``big_ba`` engine against the JAX package's."""

import numpy as np
import pytest
import torch

from slampp_tpu.linear import ba_schur as jbs
from slampp_tpu.ops.segments import RangeBucket, _range_idx
from slampp_tpu.solvers.lm import LevenbergMarquardtSolver as JLM
from slampp_tpu_torch.io.datasets import make_venice_ba_arrays
from slampp_tpu_torch.linear import ba_schur
from slampp_tpu_torch.solvers import LevenbergMarquardtSolver

from tests._torch_jax_util import (ba_scene_text, jax_text_system, jax_venice_solver,
                                   port_text_system)

torch.set_num_threads(1)
SCENE = {"n_cams": 12, "n_points": 400, "mean_track": 5}


def _port_solver(sc_f64, pair_f32=True):
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(**SCENE, seed=0)
    return ba_schur.BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, sc_f64=sc_f64,
                                            pair_f32=pair_f32, device="cpu")


def _buckets(grp, m):
    """(seg_ids, padded index rows) of each bucket of a JAX grouped plan."""
    out = []
    for b in grp.buckets:
        idx = _range_idx(b, m) if isinstance(b, RangeBucket) else b.idx
        out.append((np.asarray(b.seg_ids), np.asarray(idx)))
    return out


def test_plan_matches_jax():
    p = _port_solver(False).plan
    jp = jax_venice_solver(**SCENE, sc_f64=False).plan
    for f in ("n_c", "n_l", "n_obs", "n_distinct", "anchor_cam", "anchor_lm"):
        assert getattr(p, f) == getattr(jp, f), f
    for f in ("obs_cam", "obs_lm", "obs_uv", "obs_info", "pair_e", "pair_f", "sc_inv_map"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)), f)
    for grp, jgrp in ((p.lm_grp, jp.lm_grp), (p.cam_grp, jp.cam_grp)):
        got = [(b.seg_ids.numpy(), b.idx.numpy()) for b in grp.buckets]
        want = _buckets(jgrp, jp.n_obs)
        assert len(got) == len(want)
        for (s, i), (js, ji) in zip(got, want):
            np.testing.assert_array_equal(s, js)
            np.testing.assert_array_equal(i, ji)
    assert len(p.pair_buckets) == len(jp.pair_grp.buckets)
    for b, jb in zip(p.pair_buckets, jp.pair_grp.buckets):
        assert b.cap == jb.cap
        for f in ("seg_ids", "starts", "sizes"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)))


def test_lm_step_matches_jax_f64():
    """One step with the SC and the pair products in float64."""
    ps = _port_solver(True, pair_f32=False)
    js = jax_venice_solver(**SCENE, sc_f64=True, pair_f32=False)
    out = ba_schur.ba_schur_lm_step(ps.plan, ps._cams, ps._lms, 1e-3, sc_f64=True,
                                    pair_f32=False)
    jout = jbs.ba_schur_lm_step(js.plan, js._cams, js._lms, 1e-3, sc_f64=True, pair_f32=False)
    for got, want in zip(out, jout):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-8 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("sc_f64,tol", [(True, 1e-8), (False, 5e-3)])
def test_big_ba_optimize_matches_jax(sc_f64, tol):
    """5 LM iterations: the float64 SC with float64 pair products, and the
    float32 SC with float32 pair products (the venice bench's setting)."""
    pair_f32 = not sc_f64
    ps = _port_solver(sc_f64, pair_f32)
    js = jax_venice_solver(**SCENE, sc_f64=sc_f64, pair_f32=pair_f32)
    assert ps.optimize(5) == js.optimize(5)
    assert abs(ps.chi2() - js.chi2()) <= tol * js.chi2()


def test_parsed_graph_plan_matches_arrays():
    """build_ba_schur_plan of a parsed make_ba_scene graph against the JAX
    package's, and its step against the JAX step in float64."""
    text = ba_scene_text()
    p = ba_schur.build_ba_schur_plan(port_text_system(text), device="cpu")
    jp = jbs.build_ba_schur_plan(jax_text_system(text))
    for f in ("n_c", "n_l", "n_obs", "n_distinct", "anchor_cam", "anchor_lm"):
        assert getattr(p, f) == getattr(jp, f), f
    for f in ("obs_cam", "obs_lm", "obs_uv", "obs_info", "pair_e", "pair_f"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)), f)


def test_lm_big_ba_engine_matches_jax():
    """LevenbergMarquardtSolver(engine="big_ba") on make_ba_scene: the
    float32 SC, the same accepted steps, chi2 within 5e-3, and the states
    written back to the system."""
    text = ba_scene_text()
    system, jsystem = port_text_system(text), jax_text_system(text)
    s, js = LevenbergMarquardtSolver(system, engine="big_ba", device="cpu"), JLM(jsystem,
                                                                               engine="big_ba")
    chi0 = s.chi2()
    assert s.optimize(5) == js.optimize(5)
    assert abs(s.chi2() - js.chi2()) <= 5e-3 * js.chi2()
    assert s.chi2() < chi0
