"""Segment sums and block Hessian assembly of slampp_tpu_torch against the
JAX package, fed the JAX package's own plans through interop."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly as jax_ba
from slampp_tpu.linear.partitioned import PartitionedSolver as JaxSolver
from slampp_tpu.ops import segments as jax_seg
from slampp_tpu_torch.core import block_assembly
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.ops import segments

from _torch_jax_util import (
    assert_segments_equal,
    jax_system,
    port_block_plan,
    port_graph,
    port_system,
)

torch.set_num_threads(1)


def _random_plan(rng, m, n_seg):
    """Random sorted segments over m terms, with empty segments and a remap."""
    cuts = np.sort(rng.integers(0, m + 1, n_seg - 1))
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [m]])
    starts[n_seg // 2] = ends[n_seg // 2]  # force one empty segment
    remap = np.concatenate([rng.permutation(m), [m]])
    return starts, ends, remap


@pytest.mark.parametrize("axis", ["last", "first"])
def test_grouped_segsum_matches_jax(axis):
    rng = np.random.default_rng(11)
    for m, n_seg in ((50, 7), (400, 60), (1000, 9)):
        starts, ends, remap = _random_plan(rng, m, n_seg)
        plan = segments.plan_grouped_segments(starts, ends, m, remap=remap)
        jplan = jax_seg.plan_grouped_segments(starts, ends, m, remap=remap)
        assert_segments_equal(plan, jplan)
        if axis == "last":
            data = rng.normal(size=(9, m))
            got = segments.grouped_segsum_last(torch.from_numpy(data), plan)
            want = jax_seg.grouped_segsum_last(jnp.asarray(data), jplan)
        else:
            data = rng.normal(size=(m, 3, 2))
            got = segments.grouped_segsum_first(torch.from_numpy(data), plan)
            want = jax_seg.grouped_segsum_first(jnp.asarray(data), jplan)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def jax_graph_and_plan():
    system = jax_system(150)
    ps = JaxSolver(system, target=32)
    ps.symbolic()
    return system.snapshot(), ps.block_plan


@pytest.mark.parametrize("hessian_f32", [False, True])
def test_assemble_blocks_sorted_matches_jax(jax_graph_and_plan, hessian_f32):
    jg, jbp = jax_graph_and_plan
    vals_j, rhs_j, chi2_j = jax.jit(
        lambda g: jax_ba.assemble_blocks_sorted(g, jbp, hessian_f32=hessian_f32)
    )(jg)
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(
        port_graph(jg), port_block_plan(jbp), hessian_f32=hessian_f32
    )
    assert vals.dtype == (torch.float32 if hessian_f32 else torch.float64)
    assert rhs.dtype == chi2.dtype == torch.float64
    if hessian_f32:
        # rtol 1e-5 of each block's scale: f32 terms of a block sum in
        # another order, and entries that cancel to ~0 keep an absolute
        # error of the order of the largest term's rounding
        vj = np.asarray(vals_j)
        scale = np.abs(vj).max(axis=(1, 2), keepdims=True)
        assert (np.abs(vals.numpy() - vj) <= 1e-5 * scale).all()
    else:
        np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(rhs.numpy(), np.asarray(rhs_j), rtol=0, atol=1e-10)
    assert abs(float(chi2) - float(chi2_j)) < 1e-10


def test_scatter_dx_matches_jax(jax_graph_and_plan):
    _, jbp = jax_graph_and_plan
    x = np.random.default_rng(2).normal(size=(jbp.n, jbp.bs))
    want = jax_ba.scatter_dx(jbp, jnp.asarray(x), jbp.bs)
    got = block_assembly.scatter_dx(port_block_plan(jbp), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_block_plan_matches_jax(jax_graph_and_plan):
    _, jbp = jax_graph_and_plan
    ps = PartitionedSolver(port_system(150), target=32)
    ps.symbolic()
    bp = ps.block_plan
    assert (bp.n, bp.bs, bp.nnzb, bp.state_dim, bp.type_order) == (
        jbp.n, jbp.bs, jbp.nnzb, jbp.state_dim, jbp.type_order)
    assert (bp.anchor_diag_slot, bp.anchor_off, bp.anchor_dim) == (
        jbp.anchor_diag_slot, jbp.anchor_off, jbp.anchor_dim)
    np.testing.assert_array_equal(bp.dx_offsets.numpy(), np.asarray(jbp.dx_offsets))
    np.testing.assert_array_equal(bp.asm_inv_map.numpy(), np.asarray(jbp.asm_inv_map))
    np.testing.assert_array_equal(bp.rhs_inv_map.numpy(), np.asarray(jbp.rhs_inv_map))
    assert_segments_equal(bp.asm_grp, jbp.asm_grp)
    assert_segments_equal(bp.rhs_grp, jbp.rhs_grp)
    for t, r in jbp.routing.items():
        assert bp.routing[t].pairs == r.pairs
        np.testing.assert_array_equal(bp.routing[t].pair_transpose.numpy(),
                                      np.asarray(r.pair_transpose))
