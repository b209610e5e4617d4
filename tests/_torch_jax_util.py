"""Shared helpers of the tests/test_torch_*.py files: build the same graph in
both packages, and hand JAX objects to the port as NumPy arrays through
slampp_tpu_torch.interop."""

import os
import tempfile

import numpy as np


def _with_text_file(text, fn):
    with tempfile.NamedTemporaryFile("w", suffix=".g2o", delete=False) as f:
        f.write(text)
        path = f.name
    try:
        return fn(path)
    finally:
        os.unlink(path)


def jax_system(n_poses, seed=0, loop_prob=0.1):
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=loop_prob, seed=seed)
    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def port_system(n_poses, seed=0, loop_prob=0.1):
    from slampp_tpu_torch.io.datasets import make_manhattan
    from slampp_tpu_torch.io.parser import build_system, parse_file

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=loop_prob, seed=seed)
    return _with_text_file(text, lambda p: build_system(parse_file(p)))


def np_segments(g):
    return (g.m, g.n_seg, [(np.asarray(b.seg_ids), np.asarray(b.idx)) for b in g.buckets])


def port_graph(jg):
    """JAX GraphArrays -> the port's (unpadded snapshots only)."""
    from slampp_tpu_torch import interop

    assert jg.diag_reg is None
    fields = ("local_idx", "offsets", "meas", "sigma_inv", "valid")
    return interop.graph_arrays(
        {k: np.asarray(v) for k, v in jg.states.items()},
        {k: np.asarray(v) for k, v in jg.vertex_offsets.items()},
        {k: {f: np.asarray(getattr(e, f)) for f in fields} for k, e in jg.edges.items()},
        jg.state_dim, jg.unary_offset, jg.unary_dim, jg.unary_information,
    )


def port_block_plan(jbp):
    """JAX BlockPlan (panel=1) -> the port's."""
    from slampp_tpu_torch import interop

    assert jbp.P == jbp.bs and not np.asarray(jbp.panel_diag_reg).any()
    return interop.block_plan({
        "n": jbp.n, "bs": jbp.bs, "nnzb": jbp.nnzb,
        "routing": {k: {"pair_transpose": np.asarray(r.pair_transpose), "pairs": r.pairs}
                    for k, r in jbp.routing.items()},
        "anchor_diag_slot": jbp.anchor_diag_slot, "anchor_off": jbp.anchor_off,
        "anchor_dim": jbp.anchor_dim, "unary_information": jbp.unary_information,
        "dx_offsets": np.asarray(jbp.dx_offsets), "state_dim": jbp.state_dim,
        "type_order": jbp.type_order,
        "asm_grp": np_segments(jbp.asm_grp), "asm_inv_map": np.asarray(jbp.asm_inv_map),
        "rhs_grp": np_segments(jbp.rhs_grp), "rhs_inv_map": np.asarray(jbp.rhs_inv_map),
    })


def port_v3_plan(jp):
    """JAX V3Plan -> the port's."""
    from slampp_tpu_torch import interop

    def conv(v):
        if hasattr(v, "buckets"):
            return np_segments(v)
        if isinstance(v, int):
            return v
        return np.asarray(v)

    return interop.v3_plan({k: conv(getattr(jp, k)) for k in jp._fields})


def assert_segments_equal(a, b):
    """A port GroupedSegments equals a JAX one, bucket by bucket."""
    assert (a.m, a.n_seg, len(a.buckets)) == (b.m, b.n_seg, len(b.buckets))
    for x, y in zip(a.buckets, b.buckets):
        np.testing.assert_array_equal(x.seg_ids.numpy(), np.asarray(y.seg_ids))
        np.testing.assert_array_equal(x.idx.numpy(), np.asarray(y.idx))
