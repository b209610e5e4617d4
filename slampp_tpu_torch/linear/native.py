"""Native block-sparse Cholesky linear solver (counterpart of
``slampp_tpu/linear/native.py``) — the default for pose graphs, like the
reference's CLinearSolver_UberBlock (include/slam/LinearSolver_UberBlock.h:45).

Pipeline (symbolic cached per graph structure):
  host: block adjacency -> fill-reducing ordering -> ``panel`` consecutive
        ordered blocks amalgamated into one panel -> symbolic factor and
        level schedule (v1: core/symbolic.py; v2: core/sparse_chol2.plan_v2)
        -> edge-to-slot routing (core/block_assembly.py)
  device: sorted block assembly -> level-by-level factorization and
        triangular solves (v1: core/sparse_chol.py, scatter-add levels; v2:
        core/sparse_chol2.py, level windows and prefix-sum reductions) ->
        un-permuted dx.

``optimize_fused`` (v2) chains K Gauss-Newton iterations with no host read
between them.  On a CUDA device one iteration is captured once as a CUDA
graph (per plan, precision and refinement count) and replayed K times —
the counterpart of the JAX package's K iterations as one jitted program.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from slampp_tpu_torch.core import block_assembly, ordering as ord_mod, sparse_chol, sparse_chol2, symbolic
from slampp_tpu_torch.core.assembly import apply_update, graph_chi2
from slampp_tpu_torch.graph.system import EdgeArrays, GraphArrays, GraphSystem
from slampp_tpu_torch.utils.device import require_device


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
        """``panel`` > 1 groups ``panel`` consecutive ordered block columns
        into dense P x P panels (P = panel * bs) on a shallower elimination
        tree.  ``mixed_precision`` factors in float32 with static damping and
        float64 iterative refinement (``refine_iters`` rounds).  ``engine``:
        "v1" (scatter-add levels) or "v2" (level windows and prefix-sum
        segment reductions, core/sparse_chol2.py)."""
        if engine not in ("v1", "v2"):
            raise ValueError(f"unknown engine {engine!r}")
        if panel < 1:
            raise ValueError(f"panel must be >= 1, got {panel}")
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
        self.plan2: Optional[sparse_chol2.PlanV2] = None
        self._graphs: Dict[tuple, _CapturedStep] = {}

    @property
    def n_levels(self) -> int:
        return (self.plan2 or self.dplan).n_levels

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

        # coarsen the permuted pairs to panel granularity (supernodal
        # amalgamation of `panel` consecutive ordered columns)
        p = self.panel
        n_panels = (n + p - 1) // p
        ppairs = sorted({(int(inv[i]) // p, int(inv[j]) // p) for i, j in pairs
                         if int(inv[i]) // p != int(inv[j]) // p})
        self._graphs = {}
        if self.engine == "v2":
            plan2 = sparse_chol2.plan_v2(n_panels, ppairs, self.device)
            # compose the level-contiguous panel renumbering into the fine
            # permutation: panel q sits at new position new_of[q]
            new_of = np.empty(n_panels, np.int64)
            new_of[plan2.col_order] = np.arange(n_panels)
            inv2 = new_of[inv // p] * p + inv % p
            self.plan2, self.dplan = plan2, None
            self.block_plan = block_assembly.build_block_plan(
                system, plan2.slot_of, plan2.diag_slot, plan2.n + plan2.n_off, inv2,
                block_of_vid, panel=p,
            ).to(self.device)
        else:
            plan = symbolic.symbolic_cholesky(n_panels, ppairs)
            self.dplan, self.plan2 = sparse_chol.device_plan(plan, self.device), None
            self.block_plan = block_assembly.build_block_plan(
                system, plan.slot_of, plan.diag_slot, plan.nnzb, inv, block_of_vid, panel=p
            ).to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            self.symbolic()

    def gn_step(self, graph: GraphArrays):
        """One GN iteration through the sparse path: (new_states, dx_norm,
        chi2 at entry), all on the device."""
        self.ensure_symbolic()
        if self.engine == "v2":
            return _native_gn_step_v2(graph, self.block_plan, self.plan2, self.mixed_precision,
                                      self.refine_iters)
        return _native_gn_step(graph, self.block_plan, self.dplan, self.mixed_precision,
                               self.refine_iters)

    def optimize_fused(self, graph: GraphArrays, n_iters: int = 5):
        """``n_iters`` chained GN iterations (v2 engine) with no early exit
        and no host read: (final states, dx_norm of the last iteration, chi2
        before the first, chi2 after the last).  On a CUDA device the
        iteration runs as a captured CUDA graph; a capture that fails
        raises."""
        self.ensure_symbolic()
        if self.engine != "v2":
            raise ValueError("optimize_fused requires engine='v2'")
        if graph.device.type == "cuda":
            return self._optimize_graphed(graph, n_iters)
        states, dxn, chi0 = graph.states, None, None
        for _ in range(n_iters):
            states, dxn, chi2 = self.gn_step(graph.replace_states(states))
            if chi0 is None:
                chi0 = chi2
        return states, dxn, chi0, graph_chi2(graph.replace_states(states))

    def captured_step(self, graph: GraphArrays) -> "_CapturedStep":
        """The CUDA graph of one v2 GN iteration for the current plan,
        precision and refinement count, captured at first use."""
        key = (self.mixed_precision, self.refine_iters)
        if key not in self._graphs:
            bp, plan2 = self.block_plan, self.plan2
            mixed, refine = key
            self._graphs[key] = _CapturedStep(
                graph, lambda g: _native_gn_step_v2(g, bp, plan2, mixed, refine))
        return self._graphs[key]

    def _optimize_graphed(self, graph: GraphArrays, n_iters: int):
        step = self.captured_step(graph)
        step.load(graph)
        dxn = chi0 = None
        for _ in range(n_iters):
            step.replay()
            if chi0 is None:
                chi0 = step.out[2].clone()
        if n_iters:
            dxn = step.out[1].clone()
        states = {t: v.clone() for t, v in step.graph.states.items()}
        return states, dxn, chi0, graph_chi2(graph.replace_states(states))


class _CapturedStep:
    """One GN iteration captured as a CUDA graph, from static input buffers
    (``graph``, a private copy of the caller's snapshot) to static outputs
    (``out`` = (states, dx_norm, chi2)).  ``replay`` runs the iteration and
    copies the output states back into the input buffer, so consecutive
    replays chain iterations."""

    def __init__(self, graph: GraphArrays, step):
        dev = graph.device
        with torch.cuda.device(dev):
            self.graph = _clone_graph(graph)
            # warm-up outside the capture (library handles, workspaces)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                step(self.graph)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            self.cuda_graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(self.cuda_graph):
                self.out = step(self.graph)
            self.nodes = _graph_node_count(self.cuda_graph.raw_cuda_graph())
            self.cuda_graph.instantiate()
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0

    def load(self, graph: GraphArrays) -> None:
        """Copy a snapshot of the same structure into the input buffers."""
        for mine, theirs in zip(_graph_tensors(self.graph), _graph_tensors(graph)):
            if mine.shape != theirs.shape:
                raise ValueError("the snapshot's structure differs from the captured one")
            mine.copy_(theirs)

    def replay(self) -> None:
        self.cuda_graph.replay()
        for t, st in self.graph.states.items():
            st.copy_(self.out[0][t])


def _graph_tensors(graph: GraphArrays):
    yield from (graph.states[k] for k in sorted(graph.states))
    yield from (graph.vertex_offsets[k] for k in sorted(graph.vertex_offsets))
    for k in sorted(graph.edges):
        yield from (getattr(graph.edges[k], f.name) for f in dataclasses.fields(EdgeArrays))


def _clone_graph(graph: GraphArrays) -> GraphArrays:
    return dataclasses.replace(
        graph,
        states={k: v.clone() for k, v in graph.states.items()},
        vertex_offsets={k: v.clone() for k, v in graph.vertex_offsets.items()},
        edges={k: EdgeArrays(*(getattr(e, f.name).clone() for f in dataclasses.fields(e)))
               for k, e in graph.edges.items()},
    )


def _graph_node_count(raw_graph: int) -> int:
    """Nodes of a captured cudaGraph_t, through the driver API."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(count))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return count.value


def _native_gn_step(graph: GraphArrays, bp, dp, mixed: bool, refine: int):
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp)
    if mixed:
        x = sparse_chol.solve_refined(dp, vals[:-1], -rhs[:-1], refine_iters=refine)
    else:
        x = sparse_chol.solve(dp, sparse_chol.factorize(dp, vals[:-1]), -rhs[:-1])
    dx = block_assembly.scatter_dx(bp, x)
    return apply_update(graph, dx), torch.linalg.norm(dx), chi2


def _native_gn_step_v2(graph: GraphArrays, bp, plan2, mixed: bool, refine: int):
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp)
    n, n_off = plan2.n, plan2.n_off
    D, O, b = vals[:n], vals[n : n + n_off], -rhs[:-1]
    if mixed:
        x = sparse_chol2.solve_refined2(plan2, D, O, b, refine_iters=refine)
    else:
        x = sparse_chol2.solve2(plan2, *sparse_chol2.factorize2(plan2, D, O), b)
    dx = block_assembly.scatter_dx(bp, x)
    return apply_update(graph, dx), torch.linalg.norm(dx), chi2
