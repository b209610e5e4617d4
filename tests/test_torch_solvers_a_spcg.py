"""The A and SPCG solvers of slampp_tpu_torch and the edge-masked block
plan against the JAX package: ``build_jacobian``'s A and b; ``ASolver``
against the port's dense Gauss-Newton; SPCG's spanning tree, its edge
mask and the masked plan equal to the JAX package's; SPCG's chi2 and CG
iteration counts on manhattan500.

The CG counts at manhattan500 (tolerance 1e-8 relative, reached after 43
to 47 iterations) follow rounding: the JAX package's own counts move by up
to 2 per step when its start states are scaled by 1 + 1e-15 N(0, 1)
(``python tests/_torch_jax_util.py --sensitivity``), and the port's tree factor differs from the JAX one by
1e-12 relative (prefix-sum segment sums rounded in another order), which
the tree system's conditioning turns into a 1e-9 difference of the
preconditioned residual.  So the counts are held within 2 of the JAX
package's, the chi2 within 1e-9."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from slampp_tpu.linear.spcg import SPCGSolver as JSPCG
from slampp_tpu.linear.spcg import _spanning_tree as jax_spanning_tree
from slampp_tpu.solvers.a_solver import build_jacobian as jax_build_jacobian
from slampp_tpu_torch.core import block_assembly
from slampp_tpu_torch.linear.spcg import SPCGSolver, _spanning_tree
from slampp_tpu_torch.solvers import GaussNewtonSolver
from slampp_tpu_torch.solvers.a_solver import ASolver, build_jacobian

from _torch_jax_util import (assert_segments_equal, jax_spcg, jax_system, jax_text_system,
                             port_system, port_text_system)

torch.set_num_threads(1)


@pytest.mark.parametrize("graph", ["manhattan", "sphere-landmarks"])
def test_build_jacobian_matches_jax(graph):
    """A = R J and b = R r in the same row order (edge type, edge,
    component) on an SE(2) graph and on SE(3) poses with XYZ landmarks."""
    if graph == "manhattan":
        system, jsystem = port_system(80), jax_system(80)
    else:
        from slampp_tpu_torch.io.datasets import make_sphere_landmarks

        text = make_sphere_landmarks(n_poses=40, n_rings=2, seed=0)[0]
        system, jsystem = port_text_system(text), jax_text_system(text)
    A, b = build_jacobian(system.snapshot("cpu"))
    jA, jb = jax.jit(jax_build_jacobian)(jsystem.snapshot())
    assert A.shape == jA.shape and b.shape == jb.shape
    scale = float(np.abs(np.asarray(jA)).max())
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-12 * max(float(np.abs(np.asarray(jb)).max()), 1.0))


def test_a_solver_matches_gauss_newton():
    """The A solver's step is the lambda solver's (A^T A = lambda): the
    same iterations applied and chi2 within 1e-10 of dense GN; r_A() is the
    last iteration's (m, N) Jacobian."""
    a = ASolver(port_system(300), device="cpu")
    gn = GaussNewtonSolver(port_system(300), linear_solver="dense", device="cpu")
    assert a.optimize(5, 0.01) == gn.optimize(5, 0.01)
    assert abs(a.chi2() - gn.chi2()) <= 1e-10 * gn.chi2()
    A = a.r_A()
    assert A.shape[1] == a.system.state_dim and A.shape[0] == 3 * a.system.n_edges


@pytest.fixture(scope="module")
def spcg_pair():
    s = SPCGSolver(port_system(500), device="cpu")
    js = JSPCG(jax_system(500))
    s.ensure_symbolic()
    js.ensure_symbolic()
    return s, js


def test_spanning_tree_and_masked_plan_match_jax(spcg_pair):
    """The BFS tree, the edge mask and the tree system's edge-masked plan
    (``build_block_plan(..., edge_mask=...)``) equal the JAX package's, and
    the masked assembly gives the same tree system; without a mask the plan
    is the unmasked one."""
    s, js = spcg_pair
    system, jsystem = s.system, js.system
    block_of = {vid: b for b, vid in enumerate(system._vorder)}
    links, mask, elim = _spanning_tree(system, block_of)
    jlinks, jmask, jelim = jax_spanning_tree(jsystem, dict(block_of))
    assert links == jlinks and elim == jelim
    for t in jmask:
        np.testing.assert_array_equal(mask[t], jmask[t])
    assert 0 < s.tree_fraction == js.tree_fraction < 1
    bp, jbp = s._bp_tree, js._bp_tree
    assert (bp.n, bp.bs, bp.nnzb, bp.state_dim, bp.type_order) == (
        jbp.n, jbp.bs, jbp.nnzb, jbp.state_dim, jbp.type_order)
    assert (bp.anchor_diag_slot, bp.anchor_off) == (jbp.anchor_diag_slot, jbp.anchor_off)
    np.testing.assert_array_equal(bp.dx_offsets.numpy(), np.asarray(jbp.dx_offsets))
    np.testing.assert_array_equal(bp.asm_inv_map.numpy(), np.asarray(jbp.asm_inv_map))
    np.testing.assert_array_equal(bp.rhs_inv_map.numpy(), np.asarray(jbp.rhs_inv_map))
    assert_segments_equal(bp.asm_grp, jbp.asm_grp)
    assert_segments_equal(bp.rhs_grp, jbp.rhs_grp)
    for t, r in jbp.routing.items():
        np.testing.assert_array_equal(bp.routing[t].pair_transpose.numpy(),
                                      np.asarray(r.pair_transpose))
    from slampp_tpu.core import block_assembly as jba

    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(system.snapshot("cpu"), bp)
    jvals, jrhs, jchi2 = jba.assemble_blocks_sorted(jsystem.snapshot(), jbp)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rhs.numpy(), np.asarray(jrhs), rtol=0, atol=1e-9)
    # an all-true mask routes as no mask does
    p2 = s._plan2
    new_of = np.empty(p2.n, np.int64)
    new_of[p2.col_order] = np.arange(p2.n)
    inv = np.empty(p2.n, np.int64)
    inv[np.asarray(elim, np.int64)] = np.arange(p2.n)
    args = (system, p2.slot_of, p2.diag_slot, p2.n + p2.n_off, new_of[inv], block_of)
    plain = block_assembly.build_block_plan(*args)
    full = block_assembly.build_block_plan(
        *args, edge_mask={t: np.ones_like(m) for t, m in mask.items()})
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(full, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert_segments_equal(plain.asm_grp, jax_grp(full.asm_grp))


def jax_grp(g):
    """A port GroupedSegments as assert_segments_equal's second argument."""
    return g._replace(buckets=tuple(b._replace(seg_ids=b.seg_ids.numpy(), idx=b.idx.numpy())
                                    for b in g.buckets))


def test_spcg_matches_jax():
    """Five GN steps with spanning-tree-preconditioned CG on manhattan500:
    the same iterations applied, chi2 within 1e-9 of the JAX package's, the
    CG iterations of every step within 2 of its (module docstring)."""
    system = port_system(500)
    s = SPCGSolver(system, device="cpu")
    applied = s.optimize(5, 0.01)
    chi2, japplied, jcounts = jax_spcg(jax_system(500))
    assert applied == japplied
    assert abs(s.chi2() - chi2) <= 1e-9 * chi2
    assert len(s.cg_counts) == len(jcounts)
    assert all(abs(a - b) <= 2 for a, b in zip(s.cg_counts, jcounts)), (s.cg_counts, jcounts)
