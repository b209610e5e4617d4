"""Subgraph-preconditioned conjugate gradient (SPCG) nonlinear solver
(counterpart of ``slampp_tpu/linear/spcg.py``; the reference's
CNonlinearSolver_SPCG, include/slam/NonlinearSolver_SPCG.h:61).

Gauss-Newton where each linear system is solved by conjugate gradients
preconditioned with a spanning-tree subgraph's factorization, as the JAX
package builds it:

* the tree is a BFS spanning tree of the block graph rooted at the gauge
  anchor; its system is assembled from the same GraphArrays as the full
  Hessian through an edge-masked block plan (``build_block_plan``'s
  ``edge_mask``) and factored children before parents on the v2 engine
  (``core/sparse_chol2.py``), which adds no fill;
* the full-H matvec is the v3 fine-block spmv
  (``linear/partitioned._spmv_fine``);
* every edge whose endpoints all lie on tree links joins the
  preconditioner (the reference keeps exactly n - 1 tree edges).

The JAX package runs the PCG loop as one ``lax.while_loop``; here it is a
host loop whose stopping test reads ||r||^2 from the device each
iteration, with the same test.  On the card one CG iteration (the spmv,
the tree solve's level sweeps, the vector updates: thousands of small
launches) is captured once as a CUDA graph over static buffers that each
GN step loads, and replayed per iteration.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from slampp_tpu_torch.core import block_assembly, sparse_chol2
from slampp_tpu_torch.core.assembly import apply_update, graph_chi2
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.linear.native import _graph_node_count
from slampp_tpu_torch.linear.partitioned import PartitionedSolver, _spmv_fine
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer


def _to_fine(bp, x: torch.Tensor) -> torch.Tensor:
    """A global vector in a block plan's (n, P) permuted layout."""
    return torch.cat([x, x.new_zeros(max(bp.P, 8))])[bp.dx_offsets]


def _block_links(system: GraphSystem, block_of_vid, vids):
    """The (hi, lo) block pairs of one edge's free, distinct vertices."""
    bs_ = [block_of_vid.get(v, -1) for v in vids]
    for x in range(len(bs_)):
        for y in range(x + 1, len(bs_)):
            if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                a, b = sorted((bs_[x], bs_[y]))
                yield b, a


def _spanning_tree(system: GraphSystem, block_of_vid):
    """BFS spanning tree over the free-vertex block graph, rooted at the
    gauge anchor (the reference roots at vertex 0,
    NonlinearSolver_SPCG.h:248).  Returns (tree_links {(hi, lo)},
    edge_mask {type: bool[E]}, elimination order: BFS order reversed)."""
    n = len(block_of_vid)
    adj = [[] for _ in range(n)]
    link_seen = set()
    for tname in system.edge_type_names:
        for vids in system._edges[tname]["vids"]:
            for b, a in _block_links(system, block_of_vid, vids):
                if (b, a) not in link_seen:
                    link_seen.add((b, a))
                    adj[a].append(b)
                    adj[b].append(a)

    av = system._unary_anchor
    root = block_of_vid.get(av, 0) if av is not None else 0
    parent = np.full(n, -2, np.int64)
    order = []
    for start in [root] + list(range(n)):
        if n == 0 or parent[start] != -2:
            continue
        parent[start] = -1
        queue = [start]
        while queue:
            nxt = []
            for u in queue:
                order.append(u)
                for v in adj[u]:
                    if parent[v] == -2:
                        parent[v] = u
                        nxt.append(v)
            queue = nxt
    tree_links = {(max(u, int(parent[u])), min(u, int(parent[u])))
                  for u in range(n) if parent[u] >= 0}

    edge_mask = {}
    for tname in system.edge_type_names:
        vids_all = system._edges[tname]["vids"]
        edge_mask[tname] = np.array(
            [all(link in tree_links for link in _block_links(system, block_of_vid, vids))
             for vids in vids_all], bool).reshape(len(vids_all))
    return tree_links, edge_mask, order[::-1]


class SPCGSolver:
    """GN with spanning-tree-preconditioned CG (the -spcg CLI solver).
    ``cg_counts`` holds the CG iterations of every GN step."""

    name = "spcg"

    def __init__(self, system: GraphSystem, verbose: bool = False, cg_max_iters: int = 200,
                 cg_tol: float = 1e-8, target: int = 64, device="cuda"):
        self.system = system
        self.verbose = verbose
        self.cg_max_iters = cg_max_iters
        self.cg_tol = cg_tol
        self.target = target
        self.device = torch.device(device)
        self.timer = PhaseTimer()
        self._symbolic_key = None
        self.n_iterations = 0
        self.cg_counts = []
        self.tree_fraction = None  # |tree-kept edges| / |edges|
        self._graph = None  # (CUDA graph of one CG iteration, its static state)
        self.graph_nodes = self.capture_s = None

    # ------------------------------------------------------------- symbolic
    def symbolic(self) -> None:
        require_device(self.device, "SPCGSolver")
        system = self.system
        # the full H: the v3 fine-block plan, for assembly and spmv
        ps = PartitionedSolver(system, target=self.target, mixed_precision=False,
                               refine_iters=0, device=self.device)
        ps.symbolic()
        self._bp_full, self._p_full = ps.block_plan, ps.plan

        # the tree: masked assembly and the fill-free v2 factorization
        block_of_vid = {vid: b for b, vid in enumerate(system._vorder)}
        n = len(block_of_vid)
        tree_links, edge_mask, elim = _spanning_tree(system, block_of_vid)
        kept = sum(int(m.sum()) for m in edge_mask.values())
        self.tree_fraction = kept / max(sum(len(m) for m in edge_mask.values()), 1)

        inv = np.empty(n, np.int64)
        inv[np.asarray(elim, np.int64)] = np.arange(n)
        tpairs = sorted({(int(max(inv[i], inv[j])), int(min(inv[i], inv[j])))
                         for i, j in tree_links})
        plan2 = sparse_chol2.plan_v2(n, tpairs, self.device)
        # children-before-parents elimination of a tree adds no fill
        assert plan2.n_off == len(tpairs), "spanning tree factor has fill?"
        new_of = np.empty(n, np.int64)
        new_of[plan2.col_order] = np.arange(n)
        self._plan2 = plan2
        self._bp_tree = block_assembly.build_block_plan(
            system, plan2.slot_of, plan2.diag_slot, plan2.n + plan2.n_off, new_of[inv],
            block_of_vid, panel=1, edge_mask=edge_mask).to(self.device)
        self._symbolic_key = (system.n_vertices, system.n_edges)
        self._graph = None

    def ensure_symbolic(self):
        if self._symbolic_key != (self.system.n_vertices, self.system.n_edges):
            with self.timer.phase("symbolic"):
                self.symbolic()

    # ----------------------------------------------------------------- step
    def _cg_iteration(self, st) -> None:
        """One PCG iteration, in place on the state ``st`` (x, r, z, p, rz,
        rr; vals_f, Ld, Lo the step's operator and tree factor)."""
        bpf, pf, bpt, p2 = self._bp_full, self._p_full, self._bp_tree, self._plan2
        x, r, z, pvec, rz = st["x"], st["r"], st["z"], st["p"], st["rz"]
        Hp = block_assembly.scatter_dx(bpf, _spmv_fine(pf, st["vals_f"], _to_fine(bpf, pvec)))
        alpha = rz / torch.clamp_min(torch.dot(pvec, Hp), 1e-300)
        x.add_(alpha * pvec)
        r.sub_(alpha * Hp)
        z.copy_(block_assembly.scatter_dx(
            bpt, sparse_chol2.solve2(p2, st["Ld"], st["Lo"], _to_fine(bpt, r))))
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-300)
        pvec.mul_(beta).add_(z)
        rz.copy_(rz_new)
        st["rr"].copy_(torch.dot(r, r))

    def _iteration(self, st):
        """The iteration to run on ``st``: eager on the CPU; on the card the
        CUDA graph of ``_cg_iteration`` over static copies of ``st``,
        captured at the first step (``st`` is then loaded into them)."""
        if st["x"].device.type != "cuda":
            return st, lambda: self._cg_iteration(st)
        if self._graph is None:
            dev = st["x"].device
            static = {k: v.clone() for k, v in st.items()}
            side = torch.cuda.Stream(dev)  # warm-up outside the capture
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._cg_iteration(static)
            torch.cuda.current_stream(dev).wait_stream(side)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                self._cg_iteration(static)
            self.graph_nodes = _graph_node_count(graph.raw_cuda_graph())
            graph.instantiate()
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0
            self._graph = (graph, static)
        graph, static = self._graph
        for k, v in st.items():
            static[k].copy_(v)
        return static, graph.replay

    def step(self, graph: GraphArrays):
        """One GN step solved by PCG: (new_states, |dx|, chi2 at entry, CG
        iterations)."""
        bpf, bpt, p2 = self._bp_full, self._bp_tree, self._plan2
        vals_f, rhs_f, chi2 = block_assembly.assemble_blocks_sorted(graph, bpf)
        vals_t, _, _ = block_assembly.assemble_blocks_sorted(graph, bpt)
        Ld, Lo = sparse_chol2.factorize2(p2, vals_t[: p2.n], vals_t[p2.n: p2.n + p2.n_off])
        b = -block_assembly.scatter_dx(bpf, rhs_f[:-1])
        z = block_assembly.scatter_dx(bpt, sparse_chol2.solve2(p2, Ld, Lo, _to_fine(bpt, b)))
        st, iterate = self._iteration({
            "vals_f": vals_f, "Ld": Ld, "Lo": Lo, "x": torch.zeros_like(b), "r": b.clone(),
            "z": z, "p": z.clone(), "rz": torch.dot(b, z), "rr": torch.dot(b, b)})
        b2 = float(st["rr"])
        k = 0
        while k < self.cg_max_iters and float(st["rr"]) > self.cg_tol * self.cg_tol * b2:
            iterate()
            k += 1
        x = st["x"].clone()
        return apply_update(graph, x), torch.linalg.norm(x), chi2, k

    # ------------------------------------------------------------ interface
    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        require_device(self.device, "SPCGSolver")
        if self.system.n_edges == 0:
            return 0
        self.ensure_symbolic()
        with self.timer.phase("snapshot"):
            graph = self.system.snapshot(self.device)
        applied = 0
        for _ in range(max_iterations):
            with self.timer.phase("gn_spcg_step"):
                new_states, dxn, chi2, cg_k = self.step(graph)
                dxn = float(dxn)
            self.n_iterations += 1
            self.cg_counts.append(cg_k)
            if self.verbose:
                print(f"iter {applied}: chi2={float(chi2):.4f} |dx|={dxn:.6f} cg_iters={cg_k}")
            if not math.isfinite(dxn) or dxn <= min_dx_norm:
                break
            graph = graph.replace_states(new_states)
            applied += 1
        with self.timer.phase("writeback"):
            self.system.update_states(graph.states)
        return applied

    def chi2(self) -> float:
        require_device(self.device, "SPCGSolver")
        return float(graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
