"""Robust losses of slampp_tpu_torch against the JAX package: the seven IRLS
weight functions in both modes (scaled error norm, whitened chi), the
weighted dense and v3 block assembly of a robustified sphere graph (H, g
and the unweighted chi2 within 1e-10 of their largest entry; H's reach
1e5), Levenberg-Marquardt on the dense
engine with Cauchy weights on the 200-pose sphere (chi2 within 1e-8, some
weights below 1), and FastL's refusal of robust edges.

Each loss is used in one mode only in this file: ``apply_robust_to_system``
reuses a variant registered earlier under the same name, in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly as jax_asm
from slampp_tpu.core import block_assembly as jax_ba
from slampp_tpu.linear.partitioned import PartitionedSolver as JaxSolver
from slampp_tpu.models import robust as jax_robust
from slampp_tpu.solvers import fastl as jax_fastl
from slampp_tpu_torch.apps import manhattan
from slampp_tpu_torch.apps.sphere import sphere_system
from slampp_tpu_torch.core import assembly, block_assembly
from slampp_tpu_torch.models import robust
from slampp_tpu_torch.solvers import fastl

from _torch_jax_util import jax_solver_reference, jax_sphere_system, port_block_plan, port_graph

torch.set_num_threads(1)


@pytest.mark.parametrize("on_chi2", [False, True])
@pytest.mark.parametrize("loss", sorted(robust.LOSSES))
def test_weight_functions_match_jax(loss, on_chi2):
    """Errors from 0 through every branch of each loss (a few beyond
    Tukey's and Hampel's cut-offs), both modes, f64."""
    rng = np.random.default_rng(0)
    E = 400
    r = rng.normal(size=(E, 6)) * np.geomspace(1e-10, 300.0, E)[:, None]
    r[0] = 0.0
    G = rng.normal(size=(E, 6, 6)) * 0.3
    sigma_inv = G @ np.swapaxes(G, 1, 2) + np.eye(6)
    mk = robust.chi2_weight_fn if on_chi2 else robust.error_norm_weight_fn
    jmk = jax_robust.chi2_weight_fn if on_chi2 else jax_robust.error_norm_weight_fn
    for scale in ((1.0, 0.5) if on_chi2 else (robust.DEFAULT_SCALE, 1.0)):
        want = np.asarray(jax.vmap(jmk(loss, scale))(jnp.asarray(r), jnp.asarray(sigma_inv)))
        got = mk(loss, scale)(torch.from_numpy(r), torch.from_numpy(sigma_inv))
        assert got.shape == (E,) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-14)
        assert want.max() <= 1.0 and (want < 1.0).any()


def _robust_pair(loss, on_chi2, scale, n=60, rings=6):
    """The same sphere graph in both packages with every edge robustified."""
    jsys, psys = jax_sphere_system(n, rings), sphere_system(n, rings)
    jax_robust.apply_robust_to_system(jsys, loss=loss, scale=scale, on_chi2=on_chi2)
    robust.apply_robust_to_system(psys, loss=loss, scale=scale, on_chi2=on_chi2)
    name = f"edge_pose3d_robust_{loss}"
    assert list(jsys._edges) == list(psys._edges) == [name]
    return jsys, psys


def _perturbed(jsys, seed):
    """The graph's snapshot with the states moved off their initialization,
    so that the weights spread."""
    jg = jsys.snapshot()
    st = np.asarray(jg.states["pose3d"]).copy()
    st += np.random.default_rng(seed).normal(scale=0.3, size=st.shape)
    return jg.replace_states({"pose3d": jnp.asarray(st)})


# Huber on the error norm at a scale that reaches the perturbed errors
@pytest.mark.parametrize("loss,on_chi2,scale", [("huber", False, 0.05), ("welsch", True, 10.0)])
def test_weighted_dense_and_block_assembly_match_jax(loss, on_chi2, scale):
    jsys, psys = _robust_pair(loss, on_chi2, scale)
    jg = _perturbed(jsys, 1)
    graph = port_graph(jg)
    H_j, g_j, chi2_j = jax.jit(jax_asm.assemble_dense)(jg)
    H, g, chi2 = assembly.assemble_dense(graph)
    for got, want in ((H, H_j), (g, g_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * np.abs(want).max())
    assert abs(float(chi2) - float(chi2_j)) <= 1e-10 * float(chi2_j)
    # chi2 stays unweighted, the Hessian does not
    assert float(chi2) == pytest.approx(float(assembly.graph_chi2(graph)), rel=1e-14)
    name = next(iter(graph.edges))
    et = robust.get_edge_type(name)
    ea = graph.edges[name]
    w = et.robust_weight_fn(et.error_fn(assembly.slot_states(et, ea, graph.states), ea.meas),
                            ea.sigma_inv)
    assert float(w.min()) < 1.0

    ps = JaxSolver(jsys, target=32)
    ps.symbolic()
    bp = port_block_plan(ps.block_plan)
    for f32 in (False, True):
        vals_j, rhs_j, c_j = jax.jit(lambda g: jax_ba.assemble_blocks_sorted(
            g, ps.block_plan, hessian_f32=f32))(jg)
        vals, rhs, c = block_assembly.assemble_blocks_sorted(graph, bp, hessian_f32=f32)
        vj = np.asarray(vals_j)
        if f32:  # as tests/test_torch_assembly.py: 1e-5 of each block's scale
            scale = np.abs(vj).max(axis=(1, 2), keepdims=True)
            assert (np.abs(vals.numpy() - vj) <= 1e-5 * scale).all()
        else:
            np.testing.assert_allclose(vals.numpy(), vj, rtol=0, atol=1e-10 * np.abs(vj).max())
        # the f32 Jacobians (analytic here, jacfwd there) round apart, and
        # the rhs contracts them in f64: 1e-5 of its largest entry
        rj = np.asarray(rhs_j)
        tol = 1e-5 if f32 else 1e-10
        np.testing.assert_allclose(rhs.numpy(), rj, rtol=0, atol=tol * np.abs(rj).max())
        assert abs(float(c) - float(c_j)) <= 1e-10 * float(c_j)
        assert float(c) == pytest.approx(float(chi2), rel=1e-13)


def test_robust_lm_dense_matches_jax():
    """LM on the dense engine, Cauchy weights of the whitened error (the
    smoke's robust phase on a 200-pose sphere): chi2 within 1e-8 and the
    same iterations applied."""
    want, applied = jax_solver_reference(
        200, "lambda-lm", system=jax_sphere_system(200, 10), robust=("cauchy", True))
    res = manhattan.run_solver(200, "cpu", "lambda-lm", build=lambda n: sphere_system(n, 10),
                               robust=("cauchy", True))
    assert res["applied"] == applied
    assert abs(res["chi2_final"] - want) <= 1e-8 * want
    rw = res["robust"]
    assert rw["n_edges"] == 379 and 0.0 < rw["share_below_1"] and rw["min_weight"] < 1.0


def test_fastl_refuses_robust_edges():
    """FastL takes no robust edge in either package (the reference gap the
    port keeps)."""
    jsys, psys = _robust_pair("fair", False, robust.DEFAULT_SCALE, n=30, rings=3)
    assert not jax_fastl.supports_system(jsys)
    assert not fastl.supports_system(psys)
    assert fastl.supports_system(sphere_system(30, 3))
