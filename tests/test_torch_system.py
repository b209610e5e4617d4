"""Host pools, parser, generator, snapshot and dense assembly of
slampp_tpu_torch against the JAX package on the same Manhattan graph."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slampp_tpu.core import assembly as jax_asm
from slampp_tpu.io.datasets import make_manhattan as jax_make_manhattan
from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.io.datasets import make_manhattan
from slampp_tpu_torch.io.parser import ParsedRecord, build_system

from _torch_jax_util import jax_system, port_system

torch.set_num_threads(1)


def test_make_manhattan_text_is_identical():
    for kw in ({"n_poses": 120}, {"n_poses": 300, "loop_prob": 0.3, "seed": 5}):
        text, gt = make_manhattan(**kw)
        text_j, gt_j = jax_make_manhattan(**kw)
        assert text == text_j
        np.testing.assert_array_equal(gt, gt_j)


def test_snapshot_equals_jax():
    jg = jax_system(120).snapshot()
    g = port_system(120).snapshot("cpu")
    assert (g.state_dim, g.unary_offset, g.unary_dim, g.unary_information) == (
        jg.state_dim, jg.unary_offset, jg.unary_dim, jg.unary_information)
    assert g.states.keys() == jg.states.keys() and g.edges.keys() == jg.edges.keys()
    for t in jg.states:
        assert g.states[t].dtype == torch.float64
        np.testing.assert_array_equal(g.states[t].numpy(), np.asarray(jg.states[t]))
        np.testing.assert_array_equal(g.vertex_offsets[t].numpy(),
                                      np.asarray(jg.vertex_offsets[t]))
    for t, je in jg.edges.items():
        for f in ("local_idx", "offsets", "meas", "sigma_inv", "valid"):
            np.testing.assert_array_equal(getattr(g.edges[t], f).numpy(),
                                          np.asarray(getattr(je, f)), err_msg=f)


def test_chi2_dense_system_and_update_match_jax():
    jg = jax_system(120).snapshot()
    g = port_system(120).snapshot("cpu")
    assert abs(float(assembly.graph_chi2(g)) - float(jax_asm.graph_chi2(jg))) < 1e-10
    H, gv, chi2 = assembly.assemble_dense(g)
    Hj, gj, chi2_j = jax_asm.assemble_dense(jg)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gj), rtol=0, atol=1e-10)
    assert abs(float(chi2) - float(chi2_j)) < 1e-10
    dx = np.random.default_rng(0).normal(scale=0.3, size=g.state_dim)
    new = assembly.apply_update(g, torch.from_numpy(dx))
    new_j = jax_asm.apply_update(jg, jnp.asarray(dx))
    for t in new_j:
        np.testing.assert_allclose(new[t].numpy(), np.asarray(new_j[t]), rtol=0, atol=1e-10)


def test_build_system_rejects_unported_record_kind():
    rec = ParsedRecord("landmark2_xy", (0, 1), np.zeros(2), np.eye(2))
    with pytest.raises(ValueError, match="landmark2_xy"):
        build_system([rec])
