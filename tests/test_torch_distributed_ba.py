"""Landmark-sharded bundle adjustment of slampp_tpu_torch
(``parallel/distributed_ba.py``) on gloo ranks on the CPU against the JAX
package on the virtual CPU mesh: ``distributed_big_ba_step`` at 2 and 4
ranks against JAX's at the same mesh size (cameras, every landmark, |dx|,
chi2 and the gain denominator within 1e-9), on test_distributed_ba.py's
scene and on one whose gauge anchor is a landmark of rank 1;
``DistributedBigBASolver.optimize`` at 2 ranks (the same accepted steps,
chi2 within 1e-9); ``distributed_big_ba_marginals`` at 2 ranks (1e-9 of
the largest entry); that the sharded step takes ``ops/ba_kernels``' op
(one rank in this process); the dense ``distributed_ba_lm_step`` at 2
ranks against the dense oracle of test_distributed_ba.py (``assemble_dense`` +
``schur_solve`` at the same damping), and, marked slow, against the JAX
package's own dense distributed step (about a minute of eager
``shard_map``).

The ranks are spawned processes: they import only the port."""

import jax.numpy as jnp
import numpy as np
import pytest

from slampp_tpu.core import assembly as jassembly
from slampp_tpu.linear.schur import build_schur_plan, schur_solve
from slampp_tpu.parallel import distributed_ba as jdba
from slampp_tpu.parallel.distributed import make_mesh as jax_make_mesh
from slampp_tpu_torch.apps import distributed as apps_dist

from tests._torch_jax_util import ba_scene_text, jax_text_system

ALPHA = 1e-2
STEP_SCENE = ba_scene_text(n_cams=6, n_points=67, obs_per_point=4, seed=3)


def _anchored_on_landmark(text: str, world: int) -> str:
    """``text`` with the first observation of rank 1's first landmark moved
    to the front, so that the gauge anchor (the first edge's first vertex
    when no edge touches vertex 0 first) is that landmark."""
    lines = text.splitlines()
    lm_ids = sorted(int(ln.split()[1]) for ln in lines if ln.startswith("VERTEX_XYZ"))
    vid = lm_ids[-(-len(lm_ids) // world)]
    k = next(i for i, ln in enumerate(lines)
             if ln.startswith("EDGE_PROJECT_P2MC") and int(ln.split()[1]) == vid
             and int(ln.split()[2]) != 0)
    first = next(i for i, ln in enumerate(lines) if ln.startswith("EDGE"))
    lines.insert(first, lines.pop(k))
    return "\n".join(lines) + "\n"


def _ids(system):
    cams = sorted(v for v, (t, _) in system.vertex_index.items() if t == "cam")
    lms = sorted(v for v, (t, _) in system.vertex_index.items() if t == "xyz")
    return cams, lms


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1.0)


@pytest.mark.parametrize("anchor", ["scene", "landmark-rank1"])
@pytest.mark.parametrize("world", [2, 4])
def test_distributed_big_ba_step_matches_jax(world, anchor):
    text = STEP_SCENE if anchor == "scene" else _anchored_on_landmark(STEP_SCENE, world)
    system = jax_text_system(text)
    mesh = jax_make_mesh(world, axis="lm")
    shards = jdba.build_big_ba_shards(system, mesh)
    if anchor != "scene":
        assert shards.anchor_lm // shards.per == 1 and shards.anchor_cam == -1
    cams, lms, norm, chi2, denom = jdba.distributed_big_ba_step(shards, mesh, ALPHA)
    n_l = len(_ids(system)[1])

    res = apps_dist.run_dist_ba_step(text, ALPHA, world, "gloo", "cpu", timeout_s=300)
    assert res["rank_devices"] == ["cpu"] * world
    for k, want in (("chi2", chi2), ("dx_norm", norm), ("denom", denom)):
        assert _rel(res[k], float(want)) <= 1e-9, (k, res[k], float(want))
    np.testing.assert_allclose(res["cams"], np.asarray(cams), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res["lms"], np.asarray(lms).reshape(-1, 3)[:n_l], rtol=0,
                               atol=1e-9)


def test_distributed_big_ba_solver_matches_jax():
    text = ba_scene_text(n_cams=5, n_points=40, obs_per_point=4, seed=4)
    system = jax_text_system(text)
    applied = jdba.DistributedBigBASolver(system, jax_make_mesh(2, axis="lm")).optimize(5)
    chi2 = float(jassembly.graph_chi2(system.snapshot()))

    res = apps_dist.run_dist_ba_optimize(text, 2, "gloo", "cpu", max_iterations=5,
                                         timeout_s=300)
    assert applied > 0 and res["applied"] == applied
    assert _rel(res["chi2_final"], chi2) <= 1e-9
    assert _rel(res["system_chi2"], chi2) <= 1e-9


def test_distributed_big_ba_marginals_match_jax():
    system = jax_text_system(STEP_SCENE)
    mesh = jax_make_mesh(2, axis="lm")
    cam_cov, lm_cov = jdba.distributed_big_ba_marginals(jdba.build_big_ba_shards(system, mesh),
                                                        mesh, alpha=ALPHA)
    cam_cov = np.asarray(cam_cov)
    lm_cov = np.asarray(lm_cov).reshape(-1, 3, 3)[: len(_ids(system)[1])]

    res = apps_dist.run_dist_marginals(world=2, backend="gloo", device="cpu", alpha=ALPHA,
                                       problem=STEP_SCENE, timeout_s=300)
    for got, want in ((res["cam_cov"], cam_cov), (res["lm_cov"], lm_cov)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_sharded_step_takes_the_ba_kernel_op(monkeypatch, tmp_path):
    """``distributed_big_ba_step`` and ``distributed_big_ba_marginals`` get
    their observation terms from ``ops/ba_kernels.p2c_linearize`` (the
    kernel on the card), here in a one-rank gloo group of this process."""
    import torch.distributed as dist

    from slampp_tpu_torch.ops import ba_kernels
    from slampp_tpu_torch.parallel import distributed_ba as pdb
    from slampp_tpu_torch.parallel.distributed import make_mesh

    calls = []
    linearize = ba_kernels.p2c_linearize

    def counted(*args):
        calls.append(len(args[2]))
        return linearize(*args)

    monkeypatch.setattr(ba_kernels, "p2c_linearize", counted)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh("cpu")
        sh = pdb.build_big_ba_shards_arrays(*apps_dist.venice_scene(8, 150, 4), mesh)
        pdb.distributed_big_ba_step(sh, mesh, ALPHA)
        pdb.distributed_big_ba_marginals(sh, mesh, ALPHA)
    finally:
        dist.destroy_process_group()
    assert calls == [sh.plan.n_obs] * 2


DENSE_SCENE = ba_scene_text(n_cams=6, n_points=64, obs_per_point=4, seed=2)


def _dense_reference(oracle):
    """(cams, landmarks, |dx|, chi2) of one damped step on DENSE_SCENE in
    the JAX package: the dense oracle, or its own dense distributed step on
    a 2-device mesh."""
    system = jax_text_system(DENSE_SCENE)
    cam_ids, lm_ids = _ids(system)
    if oracle == "jax-distributed":
        mesh = jax_make_mesh(2, axis="lm")
        cams, lms, norm, chi2, _ = jdba.distributed_ba_lm_step(
            jdba.build_ba_shards(system, mesh), mesh, ALPHA)
        return np.asarray(cams), np.asarray(lms)[: len(lm_ids)], float(norm), float(chi2)
    graph = system.snapshot()
    H, g, chi2 = jassembly.assemble_dense(graph)
    dx = schur_solve(H, g, build_schur_plan(system), alpha=ALPHA)
    states = jassembly.apply_update(graph, dx)
    cams = np.stack([np.asarray(states["cam"][system.vertex_index[v][1]]) for v in cam_ids])
    lms = np.stack([np.asarray(states["xyz"][system.vertex_index[v][1]]) for v in lm_ids])
    return cams, lms, float(jnp.linalg.norm(dx)), float(chi2)


@pytest.mark.parametrize("oracle", [
    "dense-schur", pytest.param("jax-distributed", marks=pytest.mark.slow)])
def test_distributed_ba_lm_step_matches_jax(oracle):
    cams, lms, norm, chi2 = _dense_reference(oracle)
    res = apps_dist.run_dist_ba_step(DENSE_SCENE, ALPHA, 2, "gloo", "cpu", dense=True,
                                     timeout_s=300)
    assert _rel(res["chi2"], chi2) <= 1e-9
    assert _rel(res["dx_norm"], norm) <= 1e-9
    np.testing.assert_allclose(res["cams"], cams, rtol=0, atol=1e-9)
    np.testing.assert_allclose(res["lms"], lms, rtol=0, atol=1e-9)
