"""The partitioned (v3) solver of slampp_tpu_torch: its host plan against the
JAX package's, its exact mode against the dense oracle, and its mixed mode
against the JAX package and against its own exact mode (the contracts of
tests/test_partitioned.py).  On the CPU every dense kernel call takes its
plain PyTorch version."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly as jax_ba
from slampp_tpu.linear import partitioned as P
from slampp_tpu_torch.core import assembly, block_assembly
from slampp_tpu_torch.linear.partitioned import (
    PartitionedSolver,
    _cr_build,
    _cr_solve,
    _small_inv,
    _spmv_fine,
    _v3_solve_refined,
)

from _torch_jax_util import (
    assert_segments_equal,
    jax_system,
    port_graph,
    port_system,
    port_v3_plan,
)

torch.set_num_threads(1)


def _dense_dx(graph):
    H, g, _ = assembly.assemble_dense(graph)
    return torch.linalg.solve(H, -g)


@pytest.mark.parametrize("n_poses,target", [(200, 32), (400, 64)])
def test_v3_plan_matches_jax(n_poses, target):
    jps = P.PartitionedSolver(jax_system(n_poses), target=target)
    jps.symbolic()
    ps = PartitionedSolver(port_system(n_poses), target=target)
    ps.symbolic()
    for k in P.V3Plan._fields:
        a, b = getattr(ps.plan, k), getattr(jps.plan, k)
        if isinstance(b, int):
            assert a == b, k
        elif hasattr(b, "buckets"):
            assert_segments_equal(a, b)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert ps.plan.ch_ok == 1


@pytest.mark.parametrize("n_poses,target", [(120, 16), (200, 32)])
def test_v3_exact_matches_dense_oracle(n_poses, target):
    system = port_system(n_poses)
    graph = system.snapshot()
    dx_ref = _dense_dx(graph)
    ps = PartitionedSolver(system, target=target, mixed_precision=False)
    new_states, dx_norm, _ = ps.gn_step(graph)
    ref_states = assembly.apply_update(graph, dx_ref)
    for t, s in new_states.items():
        np.testing.assert_allclose(s.numpy(), ref_states[t].numpy(), rtol=0, atol=1e-8)
    n_ref = float(torch.linalg.norm(dx_ref))
    assert abs(float(dx_norm) - n_ref) < 1e-8 * (1.0 + n_ref)


def test_v3_exact_solve_on_jax_plan_matches_jax():
    """Layer by layer: the JAX package's own plan, Hessian blocks and rhs go
    into the port's solve (through interop); exact mode agrees to 1e-8."""
    system = jax_system(200)
    jps = P.PartitionedSolver(system, target=32, mixed_precision=False)
    jps.symbolic()
    jg = system.snapshot()
    vals, rhs, _ = jax.jit(lambda g: jax_ba.assemble_blocks_sorted(g, jps.block_plan))(jg)
    x_j = np.asarray(jax.jit(
        lambda v, r: P._v3_solve_refined(jps.plan, v, -r, 0, 1e-6, False))(vals, rhs))
    x = _v3_solve_refined(port_v3_plan(jps.plan), torch.from_numpy(np.array(vals)),
                          -torch.from_numpy(np.array(rhs)), 0, 1e-6, False)
    np.testing.assert_allclose(x.numpy(), x_j, rtol=0, atol=1e-8)
    assert port_graph(jg).state_dim == jg.state_dim


def test_small_inv_and_cyclic_reduction_match_jax():
    """The part-interior building blocks on their own: the closed-form tiny
    inverses and batched block cyclic reduction (two levels + the dense base
    case) on a random SPD block tridiagonal, f64."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy
    for bs in (1, 2, 3):
        G = rng.normal(size=(4, 5, bs, bs))
        A = G @ np.swapaxes(G, -1, -2) + bs * np.eye(bs)
        np.testing.assert_allclose(_small_inv(t(A)).numpy(),
                                   np.asarray(P._small_inv(jnp.asarray(A))),
                                   rtol=1e-12, atol=1e-12)
    K, m, bs = 3, 32, 3
    G = rng.normal(size=(K, m, bs, bs))
    D = G @ np.swapaxes(G, -1, -2) + 10.0 * np.eye(bs)
    Lw = rng.normal(scale=0.5, size=(K, m, bs, bs))
    Lw[:, -1] = 0.0
    B = rng.normal(size=(K, m, bs, 4))
    x = _cr_solve(*_cr_build(t(D), t(Lw)), t(B)).numpy()
    x_j = np.asarray(P._cr_solve(*P._cr_build(jnp.asarray(D), jnp.asarray(Lw)), jnp.asarray(B)))
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-10)


def test_v3_spmv_matches_dense():
    system = port_system(150)
    graph = system.snapshot()
    ps = PartitionedSolver(system, target=32)
    ps.symbolic()
    p = ps.plan
    vals = block_assembly.assemble_blocks_sorted(graph, ps.block_plan)[0].numpy()
    n, bs = p.n, p.bs
    H = np.zeros((n * bs, n * bs))
    for s_, (i, j) in enumerate(zip(p.rows.numpy(), p.cols.numpy())):
        H[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] += vals[s_]
        if i != j:
            H[j * bs : (j + 1) * bs, i * bs : (i + 1) * bs] += vals[s_].T
    xt = np.random.RandomState(0).randn(n, bs)
    y = _spmv_fine(p, torch.from_numpy(vals), torch.from_numpy(xt)).numpy()
    np.testing.assert_allclose(y.reshape(-1), H @ xt.reshape(-1), rtol=1e-10, atol=1e-10)


def test_v3_mixed_residual_small():
    system = port_system(200)
    graph = system.snapshot()
    H, g, _ = assembly.assemble_dense(graph)
    ps = PartitionedSolver(system, target=32, mixed_precision=True, refine_iters=2)
    ps.symbolic()
    vals, rhs, _ = block_assembly.assemble_blocks_sorted(graph, ps.block_plan)
    x = _v3_solve_refined(ps.plan, vals, -rhs, 2, 1e-6, True)
    dx = block_assembly.scatter_dx(ps.block_plan, x)
    assert float(torch.linalg.norm(H @ dx + g) / torch.linalg.norm(g)) < 1e-5


def test_v3_mixed_chain_matches_jax(monkeypatch):
    """The port's fixed configuration is the JAX package's
    SLAMPP_CHAIN_SEP_XLA=0: chain mode with the separator through
    chol_batched / trsm.  A fresh JAX solver (new plan serial, so no stale
    jit cache) in that configuration gives the same 5-iteration chi2."""
    monkeypatch.setattr(P, "_CHAIN_SEP_XLA", False)
    jsystem = jax_system(200)
    jps = P.PartitionedSolver(jsystem, target=32, mixed_precision=True, refine_iters=0)
    jps.symbolic()
    assert jps.plan.ch_ok == 1
    chi2_j = float(jps.optimize_fused(jsystem.snapshot(), n_iters=5)[3])
    system = port_system(200)
    ps = PartitionedSolver(system, target=32, mixed_precision=True, refine_iters=0)
    chi2 = float(ps.optimize_fused(system.snapshot(), n_iters=5)[3])
    assert abs(chi2 - chi2_j) <= 1e-5 * chi2_j


def test_v3_mixed_chi2_trajectory_tracks_f64():
    system = port_system(200)

    def run(mixed):
        graph = system.snapshot()
        ps = PartitionedSolver(system, target=32, mixed_precision=mixed, refine_iters=2)
        chis = []
        for _ in range(5):
            states, _, chi2 = ps.gn_step(graph)
            chis.append(float(chi2))
            graph = graph.replace_states(states)
        chis.append(float(assembly.graph_chi2(graph)))
        return np.array(chis)

    c64, c32 = run(False), run(True)
    assert c32[0] == c64[0]
    np.testing.assert_allclose(c32[2:], c64[2:], rtol=1e-5)
    assert c32[-1] <= c32[0]


def test_v3_chain_mode_matches_dense_frames():
    system = port_system(400, seed=2)
    graph = system.snapshot()
    ps = PartitionedSolver(system, target=64, mixed_precision=True, refine_iters=1)
    ps.symbolic()
    assert ps.plan.ch_ok == 1
    vals, rhs, _ = block_assembly.assemble_blocks_sorted(graph, ps.block_plan, hessian_f32=True)
    x_chain = _v3_solve_refined(ps.plan, vals, -rhs, 1, 1e-6, True).numpy()
    x_dense = _v3_solve_refined(ps.plan._replace(ch_ok=0), vals, -rhs, 1, 1e-6, True).numpy()
    scale = max(1.0, np.abs(x_dense).max())
    assert np.abs(x_chain - x_dense).max() / scale < 1e-2
    new_states, _, chi2 = ps.gn_step(graph)
    assert float(assembly.graph_chi2(graph.replace_states(new_states))) < 0.5 * float(chi2)


def test_v3_fused_matches_stepwise():
    system = port_system(150)
    graph = system.snapshot()
    ps = PartitionedSolver(system, target=32, mixed_precision=False)
    g = graph
    for _ in range(3):
        states, _, _ = ps.gn_step(g)
        g = g.replace_states(states)
    chi_step = float(assembly.graph_chi2(g))
    _, _, _, chi_fused = ps.optimize_fused(graph, n_iters=3)
    assert abs(float(chi_fused) - chi_step) < 1e-6 * (1 + chi_step)


def test_port_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib, slampp_tpu_torch\n"
        "for m in pkgutil.walk_packages(slampp_tpu_torch.__path__, 'slampp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'slampp_tpu.'))"
        " or k == 'slampp_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
