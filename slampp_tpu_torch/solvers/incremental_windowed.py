"""Windowed incremental solver (counterpart of
``slampp_tpu/solvers/incremental_windowed.py``).

Reference capability: ``CNonlinearSolver_FastL`` maintains the R factor and
updates only the affected trailing window per step (omega update / resumed
Cholesky, NonlinearSolver_FastL.h:818,954; BlockMatrix.h:3691).  This solver
realizes the same economics by windowed relinearization with cached Schur
contributions:

  * the trajectory is split into CHUNKS; once a chunk scrolls out of the
    active window it is FROZEN: its interior is eliminated at its current
    linearization point and only its Schur complement onto the separator
    (chunk-cut vertices + loop-closure endpoints) is kept;
  * each incremental solve works on the LIVE system only (active window +
    separator) with the cached frozen Schur prior added to the separator
    block, so per-step work is bounded by the window and separator size,
    not the trajectory length;
  * loop closures into a frozen chunk PROMOTE the endpoint to the separator
    and refreeze that one chunk (the analog of FastL's resumed Cholesky
    from the affected column);
  * per-vertex update gating (threshold) mirrors FastL/DL fluid
    relinearization (NonlinearSolver_FastL.h:1637, Lambda_DL.h:399);
  * ``optimize()`` runs a final full-graph batch solve (the reference CLI
    also batch-optimizes after the dataset ends, Main.h:1335).

The bookkeeping (freeze, promote, refreeze, fluid relinearization, the
frozen chunks' factors) is host NumPy, as in the JAX package.  The solves
run on ``device``: the tail solve is one dense Gauss-Newton step
(``gauss_newton._gn_step``), the dense live solve ``assemble_dense`` then
``solve_spd``, and the v3 live engine ``PartitionedSolver.gn_step_prior``
in float64, whose separator goes through the dense Cholesky and
triangular-solve kernels.

The JAX package reads four environment knobs; the port reads none.
``SLAMPP_INC_LIVE_ENGINE`` is the constructor keyword ``live_engine``; the
other three are the module constants ``_TAIL``, ``_FULL_SOLVE_EVERY`` and
``_V3_THRESHOLD``, at the JAX defaults.  Not ported: ``live_on_host``
(pinned the per-step solves to the host CPU against a remote TPU's dispatch
latency), the per-shape jit cache and the padded snapshots that kept its
keys stable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from slampp_tpu_torch.core import assembly
from slampp_tpu_torch.graph.system import GraphArrays, GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.linear.dense import solve_spd
from slampp_tpu_torch.linear.partitioned import PartitionedSolver
from slampp_tpu_torch.utils.device import require_device
from slampp_tpu_torch.utils.timer import PhaseTimer

_TAIL = 24               # live vertices updated by the tail fast path
_FULL_SOLVE_EVERY = 16   # steps after which an odometry step solves in full
_V3_THRESHOLD = 640      # live scalars from which "auto" takes the v3 engine


def _live_solve(graph: GraphArrays, sc, rhs_f, sep_idx, threshold):
    """One GN step on the live system with the frozen Schur prior:
    H[sep, sep] += sc;  g[sep] += rhs_f  (sep given as scalar indices)."""
    H, g, chi2 = assembly.assemble_dense(graph)
    H.index_put_((sep_idx[:, None], sep_idx[None, :]), sc, accumulate=True)
    g.index_put_((sep_idx,), rhs_f, accumulate=True)
    dx = solve_spd(H, -g)
    new_states = assembly.apply_update_gated(graph, dx, threshold)
    return new_states, torch.linalg.norm(dx), chi2


class WindowedIncrementalSolver:
    """FastL-economics incremental solver (see module docstring).

    Usage matches IncrementalSolver: call :meth:`incremental_step` after each
    ``system.add_edge``; call :meth:`optimize` once at the end.

    ``live_engine``: "auto" (v3 once the live system has ``_V3_THRESHOLD``
    scalars or more, else dense), "v3" or "dense".  ``counts`` tallies the
    full solves by engine and the tail solves.
    """

    def __init__(
        self,
        system: GraphSystem,
        chunk: int = 64,            # vertices frozen per freeze event
        window: int = 128,          # active vertices kept live
        solve_period: int = 1,      # new vertices per nonlinear solve (-nsp)
        max_iterations: int = 1,    # GN iterations per incremental solve
        update_threshold: float = 0.0,
        relin_threshold: float = 0.2,
        require_loop_closure: bool = True,
        verbose: bool = False,
        live_engine: str = "auto",
        device="cuda",
    ):
        if live_engine not in ("auto", "v3", "dense"):
            raise ValueError(f"unknown live_engine {live_engine!r}")
        self.device = torch.device(device)
        require_device(self.device, type(self).__name__)
        self.system = system
        self.tail = _TAIL   # 0 disables the tail fast path (FastL sets it)
        self._steps_since_full = 0
        self.live_engine = live_engine
        self._live_v3 = None
        self.chunk = chunk
        self.window = window
        self.solve_period = solve_period
        self.max_iterations = max_iterations
        self.update_threshold = update_threshold
        self.relin_threshold = relin_threshold
        self.require_loop_closure = require_loop_closure
        self.n_relin = 0
        self.verbose = verbose
        self.timer = PhaseTimer()
        # full solves by engine, v3 attempts that fell back to dense, tail solves
        self.counts = {"v3": 0, "v3_fallback": 0, "dense": 0, "tail": 0}

        self.n_steps = 0
        self.n_solves = 0
        self.n_freezes = 0
        self.n_refreezes = 0
        self._verts_at_last_solve = 0
        self._had_loop_closure = False
        self._known_vids: Set[int] = set()

        # windowing state (vertex ids in system insertion order)
        self.sep_ids: List[int] = []      # append-only separator
        self._sep_rank: Dict[int, int] = {}
        self.frozen: List[dict] = []      # chunk records
        self._frozen_of: Dict[int, int] = {}  # interior vid -> chunk index
        self._n_frozen_prefix = 0         # vertices [0..prefix) are processed
        # cached frozen Schur prior in separator-block coords (host, growable)
        self._sc = np.zeros((0, 0))
        self._rhs = np.zeros(0)
        self._live: Optional[GraphSystem] = None
        self._live_dirty = True
        self._bs = None
        self._edge_seen: Dict[str, int] = {}

    # ------------------------------------------------------------------ events
    def _new_edges(self):
        """Edges appended since the last call (vids lists)."""
        out = []
        for tname in self.system.edge_type_names:
            rec = self.system._edges[tname]
            seen = self._edge_seen.get(tname, 0)
            for e in range(seen, len(rec["vids"])):
                out.append(rec["vids"][e])
            self._edge_seen[tname] = len(rec["vids"])
        return out

    def incremental_step(self, edge_vertex_ids=None) -> bool:
        """Notify of appended edge(s).  ``edge_vertex_ids`` may be omitted —
        newly appended edges are discovered from the system (matches the
        parser's on_edge hook signature)."""
        self.n_steps += 1
        new_edges = [edge_vertex_ids] if edge_vertex_ids is not None else self._new_edges()
        promoted = False
        for vids in new_edges:
            new = [v for v in vids if v not in self._known_vids]
            self._known_vids.update(vids)
            if not new:
                self._had_loop_closure = True
            # a closure into a frozen interior promotes it to the separator
            # and refreezes that chunk (resumed-Cholesky analog)
            for v in vids:
                if v in self._frozen_of:
                    self._promote_and_refreeze(v)
                    promoted = True
            self._live_dirty = True

        n_new = self.system.n_vertices - self._verts_at_last_solve
        if n_new < self.solve_period:
            return False
        # freezing is driven by graph growth, not by the solve schedule —
        # otherwise closure-free stretches grow the active window unboundedly
        n_freezes0 = self.n_freezes + self.n_refreezes
        self._maybe_freeze()
        if self.require_loop_closure and not self._had_loop_closure:
            self._verts_at_last_solve = self.system.n_vertices
            return False
        # fastL economics: a pure-odometry step whose new edges all touch the
        # live TAIL updates only that tail (reference FastL's incremental
        # L-update + partial back-substitution, NonlinearSolver_FastL.h:1637);
        # loop closures, freezes, promotions, or the periodic relinearization
        # tick take the full windowed solve.  Partial (block-coordinate) GN
        # updates after a closure bend the local segment instead of
        # distributing the correction along the loop.
        self._steps_since_full += 1
        structural = (promoted
                      or (self.n_freezes + self.n_refreezes) != n_freezes0
                      or self._had_loop_closure)
        if (self.tail > 0 and not structural
                and self._live is not None  # first solve is always full
                and self._steps_since_full < _FULL_SOLVE_EVERY
                and self._tail_solve(new_edges, self.tail)):
            self.n_solves += 1
            self.counts["tail"] += 1
        else:
            self._solve()
            self._steps_since_full = 0
        self._verts_at_last_solve = self.system.n_vertices
        self._had_loop_closure = False
        return True

    def _tail_solve(self, new_edges, n_tail: int) -> bool:
        """GN over the last ``n_tail`` live vertices with the adjacent older
        vertices (and the separator set — whose states are pinned by the
        frozen Schur prior) held const.  Returns False when the new edges
        leave the tail or no gauge exists (caller falls back to the full
        windowed solve)."""
        from slampp_tpu_torch.solvers.gauss_newton import _gn_step

        order = self.system._vorder
        frozen = self._frozen_of
        sep = self._sep_rank
        live_tail: List[int] = []
        for v in reversed(order):
            if v not in frozen:
                live_tail.append(v)
                if len(live_tail) >= n_tail:
                    break
        tail_set = {v for v in live_tail if v not in sep}
        for vids in new_edges:
            for v in vids:
                if v in frozen:
                    return False
                if v not in tail_set and v not in sep:
                    return False  # endpoint outside the solved span
        with self.timer.phase("tail_build"):
            sub = GraphSystem(unary_information=0.0)
            boundary: List[int] = []
            edges = []
            for tname, e, vids in self._edge_iter():
                if any(v in frozen for v in vids):
                    continue  # frozen-chunk edges live in the SC prior
                if any(v in tail_set for v in vids):
                    edges.append((tname, e, vids))
                    for v in vids:
                        if v not in tail_set:
                            boundary.append(v)
            if not boundary:
                return False  # no gauge: let the full solve anchor it
            for v in live_tail[::-1] + boundary:
                t, _ = self.system.vertex_index[v]
                sub.add_vertex(t, v, self.system.vertex_state(v),
                               const=v not in tail_set)
            for tname, e, vids in edges:
                rec = self.system._edges[tname]
                sub.add_edge(tname, list(vids), rec["meas"][e],
                             rec["sigma_inv"][e])
            sub._unary_anchor = None

        with self.timer.phase("tail_solve"):
            graph = sub.snapshot(self.device)
            for _ in range(self.max_iterations):
                new_states, dxn, _ = _gn_step(graph, self.update_threshold)
                dxn = float(dxn)
                if not np.isfinite(dxn):
                    return False
                graph = graph.replace_states(new_states)
                if dxn < 1e-3:
                    break
        with self.timer.phase("tail_writeback"):
            sub.update_states(graph.states)
            for v in live_tail:
                self.system.set_vertex_state(v, sub.vertex_state(v))
            if self._live is not None and not self._live_dirty:
                for v in live_tail:
                    if self._live.has_vertex(v):
                        self._live.set_vertex_state(v, sub.vertex_state(v))
        return True

    # ------------------------------------------------------------------ freeze
    def _active_ids(self) -> List[int]:
        order = self.system._vorder
        return [
            v for v in order[self._n_frozen_prefix:]
            if v not in self._sep_rank
        ]

    def _maybe_freeze(self):
        while len(self._active_ids()) > self.window + self.chunk:
            self._freeze_oldest()

    def _edge_iter(self):
        for tname in self.system.edge_type_names:
            rec = self.system._edges[tname]
            for e, vids in enumerate(rec["vids"]):
                yield tname, e, vids

    def _freeze_oldest(self):
        with self.timer.phase("freeze"):
            order = self.system._vorder
            pos = {v: i for i, v in enumerate(order)}
            active = self._active_ids()
            take = active[: self.chunk]
            cut = take[-1]
            interiors = set(take[:-1])
            self._sep_add(cut)
            # endpoints of edges crossing the freeze boundary join the separator
            newer = set(active[self.chunk:])
            for tname, e, vids in self._edge_iter():
                vset = [v for v in vids if v in interiors]
                if vset and any(v in newer for v in vids):
                    for v in vset:
                        interiors.discard(v)
                        self._sep_add(v)
            if interiors:
                self._freeze_chunk(sorted(interiors, key=pos.get))
            self._n_frozen_prefix = pos[cut] + 1
            self._live_dirty = True
            self.n_freezes += 1

    def _sep_add(self, vid):
        if vid not in self._sep_rank:
            self._sep_rank[vid] = len(self.sep_ids)
            self.sep_ids.append(vid)

    def _chunk_edges(self, interiors: Set[int]):
        """Edges owned by a chunk: at least one interior endpoint (all other
        endpoints are separators by construction)."""
        out = []
        for tname, e, vids in self._edge_iter():
            if any(v in interiors for v in vids):
                out.append((tname, e, vids))
        return out

    def _freeze_chunk(self, interior_ids: List[int]):
        """Eliminate a chunk interior at the CURRENT states; cache its Schur
        contribution onto the separator."""
        interiors = set(interior_ids)
        edges = self._chunk_edges(interiors)
        bnd = sorted(
            {v for _, _, vids in edges for v in vids if v not in interiors},
            key=self._sep_rank.get,
        )
        sub = self._subsystem(interior_ids + bnd, edges,
                              anchored=self.system._unary_anchor in interiors)
        H, g, _ = assembly.assemble_dense(sub.snapshot(self.device))
        H, g = H.cpu().numpy(), g.cpu().numpy()
        bs = self._bs
        ni = len(interior_ids) * bs
        nb_ = len(bnd) * bs
        # interior-first layout is guaranteed by construction order
        A = H[:ni, :ni]
        U = H[:ni, ni : ni + nb_]
        Hss = H[ni : ni + nb_, ni : ni + nb_]
        gi, gsv = g[:ni], g[ni : ni + nb_]
        L = np.linalg.cholesky(A + 1e-12 * np.eye(ni))
        WU = np.linalg.solve(L, U)
        y = np.linalg.solve(L, gi)
        contrib_sc = Hss - WU.T @ WU
        contrib_rhs = gsv - WU.T @ y
        bnd_ranks = np.array([self._sep_rank[v] for v in bnd], np.int64)
        rec = dict(
            ids=list(interior_ids), bnd=bnd, bnd_ranks=bnd_ranks,
            L=L, WU=WU, y=y, contrib_sc=contrib_sc, contrib_rhs=contrib_rhs,
            lin_states={v: self.system.vertex_state(v).copy() for v in interior_ids},
            bnd_states={v: self.system.vertex_state(v).copy() for v in bnd},
        )
        ci = len(self.frozen)
        self.frozen.append(rec)
        for v in interior_ids:
            self._frozen_of[v] = ci
        self._sc_accumulate(rec, +1.0)

    def _sc_accumulate(self, rec, sign):
        bs = self._bs
        need = len(self.sep_ids) * bs
        if self._sc.shape[0] < need:
            sc = np.zeros((need, need))
            sc[: self._sc.shape[0], : self._sc.shape[1]] = self._sc
            self._sc = sc
            rhs = np.zeros(need)
            rhs[: len(self._rhs)] = self._rhs
            self._rhs = rhs
        idx = (rec["bnd_ranks"][:, None] * bs + np.arange(bs)[None, :]).ravel()
        self._sc[np.ix_(idx, idx)] += sign * rec["contrib_sc"]
        self._rhs[idx] += sign * rec["contrib_rhs"]

    def _promote_and_refreeze(self, vid: int):
        """A loop closure reached a frozen interior: promote it to the
        separator and refreeze its chunk without it."""
        with self.timer.phase("refreeze"):
            ci = self._frozen_of[vid]
            rec = self.frozen[ci]
            self._sc_accumulate(rec, -1.0)
            for v in rec["ids"]:
                del self._frozen_of[v]
            self._sep_add(vid)
            remaining = [v for v in rec["ids"] if v != vid]
            self.frozen[ci] = dict(rec, ids=[], contrib_sc=rec["contrib_sc"] * 0.0,
                                   contrib_rhs=rec["contrib_rhs"] * 0.0)
            if remaining:
                self._freeze_chunk(remaining)
            self._live_dirty = True
            self.n_refreezes += 1

    # ------------------------------------------------------------------ live
    def _subsystem(self, vids: List[int], edges, anchored: bool) -> GraphSystem:
        sub = GraphSystem(
            unary_information=self.system.unary_information if anchored else 0.0,
        )
        for v in vids:
            t, _ = self.system.vertex_index[v]
            sub.add_vertex(t, v, self.system.vertex_state(v))
            if self._bs is None:
                self._bs = get_vertex_type(t).dim
        if anchored:
            sub._unary_anchor = self.system._unary_anchor
        else:
            sub._unary_anchor = None
        for tname, e, vids_e in edges:
            rec = self.system._edges[tname]
            sub.add_edge(tname, list(vids_e), rec["meas"][e], rec["sigma_inv"][e])
        return sub

    def _rebuild_live(self):
        frozen_interiors = set(self._frozen_of)
        live_vids = [
            v for v in self.system._vorder if v not in frozen_interiors
        ]
        edges = []
        for tname, e, vids in self._edge_iter():
            if not any(v in frozen_interiors for v in vids):
                edges.append((tname, e, vids))
        anchored = self.system._unary_anchor not in frozen_interiors
        self._live = self._subsystem(live_vids, edges, anchored=anchored)
        self._live_dirty = False

    def _solve_v3(self, live, bs) -> bool:
        """Full live solve through the partitioned sparse engine: separator
        vertices forced into the dense core, the frozen-chunk Schur prior
        injected there (PartitionedSolver.gn_step_prior).  Never forms the
        dense live Hessian.  Returns False on non-chain-like live graphs
        (caller falls back to the dense path)."""
        if self._live_v3 is not None and self._live_v3[2] != len(self.sep_ids):
            self._live_v3 = None  # separator grew without a live rebuild
        if self._live_v3 is None:
            with self.timer.phase("v3_symbolic"):
                forced = [v for v in self.sep_ids if live.has_vertex(v)]
                ps = PartitionedSolver(
                    live, target=32, mixed_precision=False, refine_iters=0,
                    forced_separator=forced, device=self.device,
                )
                try:
                    ps.symbolic()
                except ValueError:
                    return False
                # sc (sep_ids order) -> v3 separator frame scalar map
                vorder = list(live._vorder)
                bidx = {v: i for i, v in enumerate(vorder)}
                r_of_block = {
                    int(b): r for r, b in enumerate(ps.separator_blocks)
                }
                rows = []
                for v in self.sep_ids:
                    if v not in bidx:
                        rows.append(None)
                        continue
                    r = r_of_block[bidx[v]]
                    rows.append(np.arange(r * bs, (r + 1) * bs))
                self._live_v3 = (ps, rows, len(self.sep_ids))
        ps, rows, _ = self._live_v3

        n0 = self._sc.shape[0]
        Ms = ps.plan.Ms
        sc_v3 = np.zeros((Ms, Ms))
        rp_v3 = np.zeros(Ms)
        sel = [i for i, r in enumerate(rows[: n0 // bs]) if r is not None]
        if sel:
            src = np.concatenate(
                [np.arange(i * bs, (i + 1) * bs) for i in sel]
            )
            dst = np.concatenate([rows[i] for i in sel])
            sc_v3[np.ix_(dst, dst)] = self._sc[np.ix_(src, src)]
            rp_v3[dst] = self._rhs[src]

        with self.timer.phase("snapshot"):
            graph = live.snapshot(self.device)
        g = graph
        dxn = None
        for _ in range(self.max_iterations):
            with self.timer.phase("live_solve_v3"):
                new_states, dxn, chi2 = ps.gn_step_prior(
                    g, sc_v3, rp_v3, self.update_threshold
                )
                dxn = float(dxn)
            if not np.isfinite(dxn):
                return False
            g = g.replace_states(new_states)
            if dxn < 1e-3:
                break
        with self.timer.phase("writeback"):
            live.update_states(g.states)
            for v in live.vertex_index:
                self.system.set_vertex_state(v, live.vertex_state(v))
        if self.verbose:
            print(f"wsolve(v3) #{self.n_solves}: |dx|={dxn:.4f} "
                  f"sep={len(self.sep_ids)} live={live.n_vertices}")
        self._relinearize_dirty()
        return True

    def _solve(self):
        if self._live_dirty or self._live is None:
            with self.timer.phase("rebuild_live"):
                self._rebuild_live()
                self._live_v3 = None
        live = self._live
        self.n_solves += 1
        if self._bs is None:
            t0 = next(iter(self.system.vertex_index.values()))[0]
            self._bs = get_vertex_type(t0).dim
        bs = self._bs
        want_v3 = self.live_engine == "v3" or (
            self.live_engine == "auto"
            and live.n_vertices * bs >= _V3_THRESHOLD
        )
        if want_v3:
            if self._solve_v3(live, bs):
                self.counts["v3"] += 1
                return
            self.counts["v3_fallback"] += 1
        self.counts["dense"] += 1

        with self.timer.phase("snapshot"):
            graph = live.snapshot(self.device)
        offs, _ = live._layout()
        # separator scalar indices in the live layout, in sep_ids rank order;
        # the cached prior covers the first n0 of them
        nsep = len(self.sep_ids)
        n0 = self._sc.shape[0]
        sep_idx = np.zeros(nsep * bs, np.int64)
        for r, v in enumerate(self.sep_ids):
            sep_idx[r * bs : (r + 1) * bs] = offs[v] + np.arange(bs)
        sep_t = torch.as_tensor(sep_idx[:n0], device=self.device)
        sc = torch.as_tensor(self._sc, dtype=torch.float64, device=self.device)
        rhs = torch.as_tensor(self._rhs, dtype=torch.float64, device=self.device)

        g = graph
        dxn = None
        for _ in range(self.max_iterations):
            with self.timer.phase("live_solve"):
                new_states, dxn, chi2 = _live_solve(g, sc, rhs, sep_t, self.update_threshold)
                dxn = float(dxn)
            if not np.isfinite(dxn):
                break
            g = g.replace_states(new_states)
            if dxn < 1e-3:
                break
        with self.timer.phase("writeback"):
            live.update_states(g.states)
            for v in live.vertex_index:
                self.system.set_vertex_state(v, live.vertex_state(v))
        if self.verbose:
            print(f"wsolve #{self.n_solves}: |dx|={dxn:.4f} sep={nsep} "
                  f"live={live.n_vertices} frozen={len(self._frozen_of)}")
        self._relinearize_dirty()

    def _relinearize_dirty(self):
        """Fluid relinearization (FastL's full-refactor trigger,
        NonlinearSolver_FastL.h:1637): chunks whose boundary separators moved
        more than ``relin_threshold`` since their freeze are refrozen at the
        refreshed states — their cached linearization is no longer valid."""
        if not self.frozen or self.relin_threshold <= 0:
            return
        bs = self._bs
        dirty = []
        for ci, rec in enumerate(self.frozen):
            if not rec["ids"]:
                continue
            move = max(
                (
                    float(np.max(np.abs(
                        self.system.vertex_state(v)[:bs] - rec["bnd_states"][v][:bs]
                    )))
                    for v in rec["bnd"]
                ),
                default=0.0,
            )
            if move > self.relin_threshold:
                dirty.append(ci)
        if not dirty:
            return
        with self.timer.phase("relinearize"):
            self.refresh_frozen()
            for ci in dirty:
                rec = self.frozen[ci]
                ids = rec["ids"]
                self._sc_accumulate(rec, -1.0)
                for v in ids:
                    del self._frozen_of[v]
                self.frozen[ci] = dict(rec, ids=[],
                                       contrib_sc=rec["contrib_sc"] * 0.0,
                                       contrib_rhs=rec["contrib_rhs"] * 0.0)
                self._freeze_chunk(ids)
                self.n_relin += 1

    # ---------------------------------------------------------------- refresh
    def refresh_frozen(self):
        """Back-substitute frozen-interior corrections from the cached chunk
        factors, given how much each chunk's boundary separators moved since
        the freeze: dx_i = -L^-T (y + WU dx_s).  The analog of FastL's
        resumed back-substitution of d over the full trajectory
        (NonlinearSolver_FastL.h:822) — O(sum chunk^2) host flops; the
        vertex types' local_diff and retract run on host tensors."""
        bs = self._bs
        if bs is None or not self.frozen:
            return

        def boxminus(v, ref):
            cur = self.system.vertex_state(v)
            t, _ = self.system.vertex_index[v]
            vt = get_vertex_type(t)
            if vt.local_diff is not None:
                return vt.local_diff(torch.from_numpy(cur), torch.from_numpy(ref)).numpy()
            return cur[:bs] - ref[:bs]

        upd_vids: List[int] = []
        upd_lin: List[np.ndarray] = []
        upd_dx: List[np.ndarray] = []
        for rec in self.frozen:
            if not rec["ids"]:
                continue
            dxs = np.concatenate([
                boxminus(v, rec["bnd_states"][v]) for v in rec["bnd"]
            ]) if rec["bnd"] else np.zeros(0)
            rhs_i = rec["y"] + (rec["WU"] @ dxs if len(dxs) else 0.0)
            dxi = -np.linalg.solve(rec["L"].T, rhs_i)
            for a, v in enumerate(rec["ids"]):
                upd_vids.append(v)
                upd_lin.append(rec["lin_states"][v])
                upd_dx.append(dxi[a * bs : (a + 1) * bs])
        if not upd_vids:
            return
        vt = get_vertex_type(self.system.vertex_index[upd_vids[0]][0])
        new = vt.retract(torch.from_numpy(np.stack(upd_lin)),
                         torch.from_numpy(np.stack(upd_dx))).numpy()
        for i, v in enumerate(upd_vids):
            self.system.set_vertex_state(v, new[i])

    # ------------------------------------------------------------------ final
    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        """Final full-graph batch optimization in float64 on the partitioned
        engine (exact chi2 parity with the batch solvers; the reference CLI
        does the same after parsing).  Unlike GaussNewtonSolver.optimize it
        applies each step before testing ``min_dx_norm``, and returns the
        number of steps taken."""
        self.refresh_frozen()
        with self.timer.phase("final_batch"):
            ps = PartitionedSolver(self.system, mixed_precision=False, device=self.device)
            graph = self.system.snapshot(self.device)
            it = 0
            for it in range(max_iterations):
                states, dxn, chi2 = ps.gn_step(graph)
                graph = graph.replace_states(states)
                if float(dxn) <= min_dx_norm:
                    break
            self.system.update_states(graph.states)
        return it + 1

    def chi2(self) -> float:
        with self.timer.phase("refresh_frozen"):
            self.refresh_frozen()
        return float(assembly.graph_chi2(self.system.snapshot(self.device)))

    def dump(self) -> None:
        self.timer.dump()
