"""The port's item-11 modules against the JAX package on the CPU:
BlockSparseMatrix (host ops, Matrix Market, the device products), the
SciPy backend, the sparse -dsm assembly, the scatter form of the block
assembly, checkpoints in both directions, FLOP counting, memory reports,
ATE / RPE, GraphSystem.chi2_dof / edge_count and SE(2)
relative_to_absolute.  Float64 throughout; each test states its
tolerance."""

import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp

import slampp_tpu.models  # noqa: F401  (registers the JAX package's model types)
from slampp_tpu.core import block_assembly as jax_ba
from slampp_tpu.core.bsm import BlockSparseMatrix as JaxBSM
from slampp_tpu.linear.native import NativeBlockSolver as JaxNative
from slampp_tpu_torch.core import block_assembly
from slampp_tpu_torch.core.assembly import assemble_dense, graph_chi2
from slampp_tpu_torch.core.bsm import BlockSparseMatrix
from slampp_tpu_torch.linear.native import NativeBlockSolver

from _torch_jax_util import (
    ba_scene_text,
    jax_system,
    jax_text_system,
    port_graph,
    port_system,
    port_text_system,
)

torch.set_num_threads(1)


def _pair(seed, nbr, nbc, br, bc, n):
    """The same random blocks in the port's and the JAX package's matrix."""
    rng = np.random.default_rng(seed)
    A, J = BlockSparseMatrix(nbr, nbc, br, bc), JaxBSM(nbr, nbc, br, bc)
    for _ in range(n):
        i, j, b = int(rng.integers(nbr)), int(rng.integers(nbc)), rng.normal(size=(br, bc))
        A.append_block(i, j, b)
        J.append_block(i, j, b)
    return A, J


def test_block_sparse_matrix_ops(tmp_path):
    """tests/test_containers.py:22 on the port's container (host ops to
    1e-12), and its Matrix Market file reads back to the dense matrix."""
    rng = np.random.default_rng(0)
    A = BlockSparseMatrix(3, 4, 2, 3)
    blocks = {}
    for i, j in [(0, 0), (0, 2), (1, 1), (2, 3), (2, 0)]:
        b = rng.normal(0, 1, (2, 3))
        blocks[(i, j)] = b
        A.append_block(i, j, b)
    Ad = A.to_dense()
    assert Ad.shape == (6, 12)
    np.testing.assert_allclose(A.find_block(0, 2), blocks[(0, 2)])
    x = rng.normal(0, 1, 12)
    np.testing.assert_allclose(A.matvec(x), Ad @ x, atol=1e-12)
    np.testing.assert_allclose(A.ata().to_dense(), Ad.T @ Ad, atol=1e-12)
    B = BlockSparseMatrix(4, 2, 3, 2)
    for i, j in [(0, 0), (2, 1), (3, 0)]:
        B.append_block(i, j, rng.normal(0, 1, (3, 2)))
    np.testing.assert_allclose(A.multiply(B).to_dense(), Ad @ B.to_dense(), atol=1e-12)
    np.testing.assert_allclose(A.add(A, 0.5).to_dense(), 1.5 * Ad, atol=1e-12)
    bsr = A.to_bsr()
    np.testing.assert_allclose(bsr.toarray(), Ad, atol=1e-12)
    mm = tmp_path / "a.mtx"
    A.save_matrix_market(str(mm))
    np.testing.assert_allclose(scipy.io.mmread(str(mm)).toarray(), Ad, atol=1e-12)
    A2 = BlockSparseMatrix.from_sparse(bsr.tocsr(), 2, 3)
    np.testing.assert_allclose(A2.to_dense(), Ad, atol=1e-12)
    P = A.permute(np.array([2, 0, 1]), np.arange(4))
    assert P.find_block(1, 0) is not None or P.find_block(0, 0) is not None
    vals, rows, cols = A.device_arrays("cpu")
    assert vals.shape == (5, 2, 3) and vals.dtype == torch.float64
    np.testing.assert_array_equal(rows.numpy(), A.indices()[0])


def test_device_products_match_jax():
    """ata_device / multiply_device (batched einsum + grouped segment sums
    on the CPU device) against the JAX package's XLA products: the same
    block pattern, values within 1e-12 relative."""
    A, JA = _pair(3, 60, 45, 3, 2, 400)
    B, JB = _pair(4, 45, 30, 2, 4, 300)
    for got, want in ((A.ata_device("cpu"), JA.ata_device()),
                      (A.multiply_device(B, "cpu"), JA.multiply_device(JB))):
        assert got.nnz_blocks == want.nnz_blocks
        assert set(got._slots) == set(want._slots)
        np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=1e-12, atol=1e-12)


def test_scipy_backend_matches_dense():
    """tests/test_containers.py:60 on the port's copy, and equal to the JAX
    package's backend (the same SciPy calls)."""
    from slampp_tpu.linear.scipy_solver import ScipySolver as JaxScipy
    from slampp_tpu_torch.linear.scipy_solver import ScipySolver

    rng = np.random.default_rng(1)
    n = 40
    M = rng.normal(0, 1, (n, n))
    H = M @ M.T + n * np.eye(n)
    b = rng.normal(0, 1, n)
    s = ScipySolver()
    x1 = s.solve_pos_def(H, b)
    x2 = s.solve_pos_def_blocky(H, b)
    x3 = s.solve_pos_def_blocky(2.0 * H, b)  # the cached pattern, new numbers
    x_ref = np.linalg.solve(H, b)
    np.testing.assert_allclose(x1, x_ref, atol=1e-9)
    np.testing.assert_allclose(x2, x_ref, atol=1e-9)
    np.testing.assert_allclose(x3, 0.5 * x_ref, atol=1e-9)
    np.testing.assert_array_equal(x2, JaxScipy().solve_pos_def_blocky(H, b))


def _mixed_graph(make):
    """tests/test_aux.py:221's pose / landmark graph, built by ``make()``'s
    GraphSystem class."""
    rng = np.random.default_rng(5)
    system = make()
    for i in range(12):
        system.add_vertex("pose2d", i, rng.normal(size=3))
    for i in range(6):
        system.add_vertex("landmark2d", 100 + i, rng.normal(size=2))
    for i in range(11):
        system.add_edge("edge_pose2d", [i, i + 1], rng.normal(size=3), np.eye(3))
    system.add_edge("edge_pose2d", [0, 8], rng.normal(size=3), 2 * np.eye(3))
    for i in range(6):
        system.add_edge("edge_pose_landmark2d_xy", [i, 100 + i], rng.normal(size=2), np.eye(2))
    return system


def test_assemble_sparse_csr_matches_dense_and_jax():
    """-dsm's sparse assembly on the mixed pose / landmark graph (chunks of
    4 edges) and on a BA scene (12 cameras, 300 points): equal to the
    port's dense H within 1e-9 and to the JAX package's CSR within 1e-12
    of its largest entry."""
    from slampp_tpu.core.sparse_dump import assemble_sparse_csr as jax_csr
    from slampp_tpu.graph.system import GraphSystem as JaxGraphSystem
    from slampp_tpu_torch.core.sparse_dump import assemble_sparse_csr
    from slampp_tpu_torch.graph.system import GraphSystem

    text = ba_scene_text(n_cams=12, n_points=300, seed=0)
    cases = ((_mixed_graph(GraphSystem), _mixed_graph(JaxGraphSystem), 4),
             (port_text_system(text), jax_text_system(text), 512))
    for system, jsystem, chunk in cases:
        g = system.snapshot("cpu")
        Hs = assemble_sparse_csr(g, chunk=chunk)
        Hd, _, _ = assemble_dense(g)
        np.testing.assert_allclose(Hs.toarray(), Hd.numpy(), rtol=1e-9, atol=1e-9)
        Hj = jax_csr(jsystem.snapshot(), chunk=chunk)
        # (entries the port's closed-form Jacobians make exactly zero may be
        # rounding-sized in the JAX package's: values, not patterns, compare)
        assert abs(Hs - Hj).max() <= 1e-12 * abs(Hj).max()


@pytest.mark.parametrize("engine,panel", [("v2", 1), ("v2", 4), ("v1", 1), ("v1", 8)])
def test_assemble_blocks_scatter_form(engine, panel):
    """The scatter form's counterpart (the grouped sums) against the sorted
    form on the same plan (the contract of block_assembly.py:493-494;
    tests/test_sparse_chol2.py:116) within 1e-12, and against the JAX
    package's assemble_blocks on its equal plan within 1e-12."""
    ns = NativeBlockSolver(port_system(90, seed=3, loop_prob=0.2), panel=panel, engine=engine,
                           device="cpu")
    ns.symbolic()
    jsystem = jax_system(90, seed=3, loop_prob=0.2)
    js = JaxNative(jsystem, panel=panel, engine=engine)
    js.symbolic()
    jg = jsystem.snapshot()
    g = port_graph(jg)
    v, r, c = block_assembly.assemble_blocks(g, ns.block_plan)
    vs, rs, cs = block_assembly.assemble_blocks_sorted(g, ns.block_plan)
    jv, jr, jc = jax.jit(lambda gg: jax_ba.assemble_blocks(gg, js.block_plan))(jg)
    for got, want in ((v, vs), (r, rs), (v, np.asarray(jv)), (r, np.asarray(jr))):
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert abs(float(c) - float(cs)) <= 1e-12 * (1.0 + float(cs))
    assert abs(float(c) - float(jc)) <= 1e-12 * (1.0 + float(jc))


def _same_graph(a, b):
    """Layout, states, edges and the unary anchor of two GraphSystems (of
    either package) are equal."""
    assert a._vorder == b._vorder and a.vertex_index == b.vertex_index
    assert a._vconst == b._vconst and a._unary_anchor == b._unary_anchor
    assert a.edge_type_names == b.edge_type_names and a.state_dim == b.state_dim
    for t in a.vertex_type_names:
        np.testing.assert_array_equal(np.stack(a._vstates[t]), np.stack(b._vstates[t]))
    for t in a.edge_type_names:
        for k in ("vids", "meas", "sigma_inv"):
            np.testing.assert_array_equal(np.asarray(a._edges[t][k]), np.asarray(b._edges[t][k]))


def test_checkpoint_roundtrips_between_packages(tmp_path):
    """A checkpoint written by either package loads in the other (and in
    itself) to the same layout, states, edges, const flags and unary
    anchor; the port's chi2 on the loaded graph equals the JAX package's on
    the original within 1e-12.  The anchor is moved off its default so the
    round trip carries it."""
    from slampp_tpu.core.assembly import graph_chi2 as jax_chi2
    from slampp_tpu.utils import checkpoint as jax_ckpt
    from slampp_tpu_torch.solvers import GaussNewtonSolver
    from slampp_tpu_torch.utils import checkpoint

    system = port_system(80, seed=3, loop_prob=0.5)
    GaussNewtonSolver(system, device="cpu").optimize(3, 0.01)
    system.add_vertex("pose2d", 5000, np.array([1.0, 2.0, 0.5]), const=True)
    system.add_edge("edge_pose2d", (79, 5000), np.array([0.5, 0.1, 0.0]), np.eye(3))
    system._unary_anchor = 7
    jsystem = jax_system(80, seed=3, loop_prob=0.5)

    p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_checkpoint(p_path, system, extra={"round": 1})
    from_port_in_jax, extra = jax_ckpt.load_checkpoint(p_path)
    assert extra == {"round": 1} and from_port_in_jax.bucket_granularity == 256
    _same_graph(from_port_in_jax, system)
    jax_ckpt.save_checkpoint(j_path, from_port_in_jax, extra={"round": 2})
    back, extra = checkpoint.load_checkpoint(j_path)
    assert extra == {"round": 2}
    _same_graph(back, system)
    again, _ = checkpoint.load_checkpoint(p_path)
    _same_graph(again, system)

    # the JAX package's own graph, written there, read here
    jax_ckpt.save_checkpoint(j_path, jsystem)
    loaded, extra = checkpoint.load_checkpoint(j_path)
    assert extra == {}
    _same_graph(loaded, jsystem)
    want = float(jax_chi2(jsystem.snapshot()))
    assert abs(float(graph_chi2(loaded.snapshot("cpu"))) - want) <= 1e-12 * want


def test_flops_and_memusage():
    """A 64 x 64 matmul counts 2 * 64^3 FLOPs (tests/test_aux.py:73-79, the
    JAX package's count within 10%; the counter's is exact); the memory
    report has the host's RSS, and the device statistics are None for the
    CPU."""
    from slampp_tpu.utils.flops import flops as jax_flops
    from slampp_tpu_torch.utils.flops import cost_analysis, flops
    from slampp_tpu_torch.utils.memusage import (
        device_memory_stats,
        format_memory_report,
        peak_memory_usage,
        process_memory_usage,
    )

    a = torch.ones((64, 64))
    assert flops(lambda x: x @ x, a) == 2 * 64**3
    assert flops(lambda x: x @ x, a) == pytest.approx(jax_flops(lambda x: x @ x, jnp.ones((64, 64))),
                                                      rel=0.1)
    assert cost_analysis(lambda x: torch.bmm(x, x), torch.ones(3, 8, 8))["flops"] == 3 * 2 * 8**3
    assert process_memory_usage() > 1e6 and peak_memory_usage() >= process_memory_usage()
    assert "RSS" in format_memory_report("cpu")
    assert device_memory_stats("cpu") is None


def test_error_eval_matches_jax():
    """ATE (rigid and similarity alignment), RPE and RPE-AA against the JAX
    package's functions on noisy, rotated trajectories: within 1e-12."""
    from slampp_tpu.eval import error_eval as jax_ee
    from slampp_tpu_torch.eval import error_eval as ee

    rng = np.random.default_rng(4)
    gt = np.cumsum(rng.normal(size=(120, 3)), 0)
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = 1.3 * gt @ R.T + np.array([2.0, -1.0, 0.5]) + 0.05 * rng.normal(size=gt.shape)
    for scale in (False, True):
        got, want = ee.align_umeyama(est, gt, scale), jax_ee.align_umeyama(est, gt, scale)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(ee.ate_rmse(est, gt, with_scale=scale),
                                   jax_ee.ate_rmse(est, gt, with_scale=scale), rtol=1e-12)
    assert ee.ate_rmse(est, gt, with_scale=True) < 0.1 < ee.ate_rmse(est, gt, align=False)
    for delta in (1, 5):
        np.testing.assert_allclose(ee.rpe_rmse(est[:, :2], gt[:, :2], delta),
                                   jax_ee.rpe_rmse(est[:, :2], gt[:, :2], delta), rtol=1e-12)
    aa_e, aa_g = 0.3 * rng.normal(size=(40, 3)), 0.3 * rng.normal(size=(40, 3))
    np.testing.assert_allclose(ee.rpe_aa_rmse(aa_e, aa_g, 2), jax_ee.rpe_aa_rmse(aa_e, aa_g, 2),
                               rtol=1e-12)


def test_chi2_dof_and_edge_count_match_jax():
    """GraphSystem.chi2_dof and edge_count on a BA scene (cameras, points,
    edge_p2c) and a Manhattan graph equal the JAX package's."""
    text = ba_scene_text(n_cams=6, n_points=40, seed=1)
    for system, jsystem in ((port_text_system(text), jax_text_system(text)),
                            (port_system(60), jax_system(60))):
        assert system.chi2_dof() == jsystem.chi2_dof()
        for t in jsystem.edge_type_names + ["edge_pose3d"]:
            assert system.edge_count(t) == jsystem.edge_count(t)
    assert port_system(60).edge_count("edge_pose2d") == port_system(60).n_edges


def test_se2_relative_to_absolute_matches_jax():
    """SE(2) composition, batched, against the JAX package's per-pose
    function (vmapped) within 1e-14, angles past +-pi included; and it
    inverts absolute_to_relative."""
    from slampp_tpu.geometry import se2 as jax_se2
    from slampp_tpu_torch.geometry import se2

    rng = np.random.default_rng(9)
    p1 = rng.normal(size=(200, 3)) * np.array([5.0, 5.0, 4.0])
    d = rng.normal(size=(200, 3)) * np.array([2.0, 2.0, 4.0])
    got = se2.relative_to_absolute(torch.from_numpy(p1), torch.from_numpy(d)).numpy()
    want = np.asarray(jax.vmap(jax_se2.relative_to_absolute)(jnp.asarray(p1), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    back = se2.absolute_to_relative(torch.from_numpy(p1), torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(np.cos(back - d), 1.0, atol=1e-12)
    np.testing.assert_allclose(back[:, :2], d[:, :2], atol=1e-12)
