"""Build the port's plans and graph snapshots from the JAX package's, given
as NumPy arrays.

With these, a test can feed the JAX package's exact state and plans into
each port function and compare one layer at a time, independently of the
port's own host planners.  The caller turns the JAX objects into plain
Python values (``np.asarray`` of every array; a ``GroupedSegments`` as
``(m, n_seg, [(seg_ids, idx), ...])``); nothing here imports JAX or
``slampp_tpu``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slampp_tpu_torch.core.block_assembly import BlockPlan, EdgeRouting
from slampp_tpu_torch.core.symbolic import CholeskyPlan
from slampp_tpu_torch.graph.system import EdgeArrays, GraphArrays
from slampp_tpu_torch.linear.partitioned import V3Plan
from slampp_tpu_torch.ops.segments import GroupBucket, GroupedSegments


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())


def grouped_segments(m: int, n_seg: int, buckets) -> GroupedSegments:
    """``buckets``: [(seg_ids (G,), idx (G, cap)), ...]."""
    return GroupedSegments(
        int(m), int(n_seg),
        tuple(GroupBucket(_tensor(s), _tensor(i)) for s, i in buckets),
    )


def _value(v):
    if isinstance(v, tuple) and len(v) == 3 and isinstance(v[2], (list, tuple)):
        return grouped_segments(*v)
    if isinstance(v, np.ndarray):
        return _tensor(v)
    return v


def graph_arrays(states: dict, vertex_offsets: dict, edges: dict, state_dim: int,
                 unary_offset: int, unary_dim: int, unary_information: float) -> GraphArrays:
    """``edges[name]``: dict with local_idx, offsets, meas, sigma_inv, valid."""
    return GraphArrays(
        {k: torch.from_numpy(np.array(v, dtype=np.float64)) for k, v in states.items()},
        {k: _tensor(v) for k, v in vertex_offsets.items()},
        {k: EdgeArrays(**{f.name: _tensor(e[f.name]) for f in dataclasses.fields(EdgeArrays)})
         for k, e in edges.items()},
        int(state_dim), int(unary_offset), int(unary_dim), float(unary_information),
    )


def block_plan(fields: dict) -> BlockPlan:
    """``fields``: the BlockPlan attributes; ``routing[name]`` is a dict
    with pair_transpose and pairs."""
    kw = {f.name: _value(fields[f.name]) for f in dataclasses.fields(BlockPlan)}
    kw["routing"] = {
        k: EdgeRouting(_tensor(r["pair_transpose"]).bool(), tuple(r["pairs"]))
        for k, r in fields["routing"].items()
    }
    kw["type_order"] = tuple(fields["type_order"])
    return BlockPlan(**kw)


def v3_plan(fields: dict) -> V3Plan:
    """``fields``: every V3Plan attribute."""
    kw = {k: _value(fields[k]) for k in V3Plan._fields}
    for k in ("a_pad_eye", "ss_pad_eye", "ch_pad"):
        kw[k] = kw[k].float()
    return V3Plan(**kw)


def cholesky_plan(fields: dict) -> CholeskyPlan:
    """``fields``: every CholeskyPlan attribute (NumPy arrays, ints and the
    ``slot_of`` dict) of a JAX package plan."""
    kw = {}
    for f in dataclasses.fields(CholeskyPlan):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            v = np.asarray(v, np.int64).copy()
        elif f.name == "slot_of":
            v = {(int(i), int(j)): int(s) for (i, j), s in v.items()}
        else:
            v = int(v)
        kw[f.name] = v
    return CholeskyPlan(**kw)
