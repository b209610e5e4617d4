"""Native block-sparse Cholesky linear solver, the v1 engine (counterpart of
``slampp_tpu/linear/native.py``) — the default for pose graphs, like the
reference's CLinearSolver_UberBlock (include/slam/LinearSolver_UberBlock.h:45).

Pipeline (symbolic cached per graph structure):
  host: block adjacency -> fill-reducing ordering -> symbolic factor and
        level schedule (core/symbolic.py) -> edge-to-slot routing
        (core/block_assembly.py)
  device: sorted block assembly -> level-by-level factorization and
        triangular solves (core/sparse_chol.py) -> un-permuted dx.

Not ported yet (ROADMAP.md queue 1 item 4): the v2 engine
(``core/sparse_chol2.py``), supernodal panels (``panel > 1``) and
``optimize_fused``, which needs v2; each raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from slampp_tpu_torch.core import block_assembly, ordering as ord_mod, sparse_chol, symbolic
from slampp_tpu_torch.core.assembly import apply_update
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.utils.device import require_device

V2_NOT_PORTED = ("NativeBlockSolver: {} is not ported yet (ROADMAP.md queue 1 item 4: "
                 "core/sparse_chol2.py and panel > 1)")


class NativeBlockSolver:
    """Blockwise sparse Cholesky with a cached symbolic decomposition
    (reference SymbolicDecomposition_Blocky, LinearSolver_UberBlock.h:272)."""

    def __init__(
        self,
        system: GraphSystem,
        ordering: str = "min_degree",
        panel: int = 1,
        mixed_precision: bool = False,
        refine_iters: int = 2,
        engine: str = "v1",
        device="cuda",
    ):
        """``mixed_precision`` factors in float32 with static damping and
        float64 iterative refinement (``refine_iters`` rounds)."""
        if engine == "v2":
            raise NotImplementedError(V2_NOT_PORTED.format("engine='v2'"))
        if engine != "v1":
            raise ValueError(f"unknown engine {engine!r}")
        if panel != 1:
            raise NotImplementedError(V2_NOT_PORTED.format(f"panel={panel}"))
        self.system = system
        self.ordering_kind = ordering
        self.panel = panel
        self.mixed_precision = mixed_precision
        self.refine_iters = refine_iters
        self.engine = engine
        self.device = torch.device(device)
        self._symbolic_key = None
        self.block_plan: Optional[block_assembly.BlockPlan] = None
        self.dplan: Optional[sparse_chol.DevicePlan] = None

    def symbolic(self, constrained_last=None) -> None:
        """(Re)build the ordering, symbolic factor and routing for the
        current graph structure."""
        require_device(self.device, "NativeBlockSolver")
        system = self.system
        block_of_vid = {vid: b for b, vid in enumerate(system._vorder)}
        n = len(block_of_vid)

        pairs = set()
        for tname in system.edge_type_names:
            for vids in system._edges[tname]["vids"]:
                bs_ = [block_of_vid.get(v, -1) for v in vids]
                for x in range(len(bs_)):
                    for y in range(x + 1, len(bs_)):
                        if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                            a, b = sorted((bs_[x], bs_[y]))
                            pairs.add((b, a))
        pairs = sorted(pairs)

        adj = ord_mod.block_adjacency(n, pairs)
        if self.ordering_kind == "min_degree":
            order = ord_mod.min_degree_ordering(adj, constrained_last)
        elif self.ordering_kind == "nested_dissection":
            order = ord_mod.nested_dissection_ordering(adj, constrained_last=constrained_last)
        elif self.ordering_kind == "rcm":
            order = ord_mod.rcm_ordering(adj)
        elif self.ordering_kind == "identity":
            order = ord_mod.identity_ordering(n)
        else:
            raise ValueError(self.ordering_kind)
        inv = ord_mod.inverse_ordering(order)

        ppairs = sorted({(int(inv[i]), int(inv[j])) for i, j in pairs})
        plan = symbolic.symbolic_cholesky(n, ppairs)
        self.dplan = sparse_chol.device_plan(plan, self.device)
        self.block_plan = block_assembly.build_block_plan(
            system, plan.slot_of, plan.diag_slot, plan.nnzb, inv, block_of_vid
        ).to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            self.symbolic()

    def gn_step(self, graph: GraphArrays):
        """One GN iteration through the sparse path: (new_states, dx_norm,
        chi2 at entry), all on the device."""
        self.ensure_symbolic()
        return _native_gn_step(graph, self.block_plan, self.dplan, self.mixed_precision,
                               self.refine_iters)

    def optimize_fused(self, graph: GraphArrays, n_iters: int = 5):
        raise NotImplementedError(V2_NOT_PORTED.format("optimize_fused (engine='v2')"))


def _native_gn_step(graph: GraphArrays, bp, dp, mixed: bool, refine: int):
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp)
    if mixed:
        x = sparse_chol.solve_refined(dp, vals[:-1], -rhs[:-1], refine_iters=refine)
    else:
        x = sparse_chol.solve(dp, sparse_chol.factorize(dp, vals[:-1]), -rhs[:-1])
    dx = block_assembly.scatter_dx(bp, x)
    return apply_update(graph, dx), torch.linalg.norm(dx), chi2

