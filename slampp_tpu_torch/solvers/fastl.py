"""FastL-role incremental solver: resident live system + resumed Cholesky
(counterpart of ``slampp_tpu/solvers/fastl.py``).

The reference's ``CNonlinearSolver_FastL``
(``include/slam/NonlinearSolver_FastL.h:46``) makes each incremental step
cheap: it maintains the R factor of the ordered lambda and, per step,
recomputes only the columns from the first one affected (resumed Cholesky,
``BlockMatrix.h:3691``; ``NonlinearSolver_FastL.h:818,954``), relinearizing
only vertices whose update exceeded a threshold (fluid relinearization,
:1637).

This solver keeps the windowed solver's chunk-freeze / Schur-prior
windowing (it subclasses WindowedIncrementalSolver and reuses that
bookkeeping) but keeps the LIVE window's linear system RESIDENT in host
NumPy and updates it in place per step, with no device dispatch:

  * per-vertex linearization points: H and g are built at the lin points;
    each solve computes the TOTAL correction dx and the estimate is the
    derived quantity x = retract(lin, dx) (the iSAM-style delta vector —
    what FastL's maintained d is);
  * a maintained dense Cholesky factor over the live window (LAPACK
    ``dpotrf`` / ``dtrtrs``), resumed from the first dirty column:
    appending a vertex or a tail edge re-factors a trailing block of a few
    columns; a loop closure into an old column re-factors from there;
  * fluid relinearization: vertices whose |dx| exceeds
    ``relin_update_threshold`` move their lin point and their incident edges
    are re-linearized vectorized (NumPy kernels from models/np_kernels.py),
    marking the factor dirty from the first touched column;
  * the frozen-chunk Schur prior enters H at rebuild time and enters the rhs
    every solve WITH its first-order drift term
    ``rhs_k + sc_k (lin_sep [-] freeze_states_k)``;
  * chunk freezes / promotes / relinearization events rebuild the resident
    system from scratch (vectorized assembly + one full factor) — they are
    rare, as the reference's full-refactor fallback is.

The reference's FastL is a CPU solver too: the host system is the design,
not a fallback.  The device work is ``chi2()`` and the final ``optimize()``
(the windowed solver's float64 partitioned batch on ``device``).

The SE(2) family has NumPy model kernels (models/np_kernels.py); every
other type (SE(3), ...) goes through models/torch_kernel_adapter.py, its
torch callables on CPU float64 tensors, as the JAX package's FastL takes its
jitted adapter.  Robust edges are refused (``supports_system``), as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
from scipy.linalg import solve_triangular
from scipy.linalg.lapack import dpotrf, dtrtrs

from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type
from slampp_tpu_torch.models import torch_kernel_adapter as adapter
from slampp_tpu_torch.models.np_kernels import (
    NP_EDGE_LIN,
    NP_LOCAL_DIFF,
    NP_RETRACT,
)
from slampp_tpu_torch.solvers.incremental_windowed import WindowedIncrementalSolver

_JITTER0 = 1e-12


def supports_system(system: GraphSystem) -> bool:
    """True unless robust weighting is in play (IRLS edges run through the
    windowed and batch solvers) or the vertices differ in block size (the
    separator Schur-prior bookkeeping, inherited from the windowed solver,
    assumes one), as in the JAX package."""
    if any(get_edge_type(t).robust_weight_fn is not None for t in system.edge_type_names):
        return False
    dims = {
        get_vertex_type(t).dim for t in system.vertex_type_names
    }
    return len(dims) <= 1


def _np_kernel(registry: dict, make, tname: str):
    """The type's NumPy kernel, else the torch adapter ``make(tname)``."""
    fn = registry.get(tname)
    return fn if fn is not None else make(tname)


class _EdgeStore:
    """Per-edge-type growable SoA for the resident linear system."""

    def __init__(self, et, slot_dims, res_dim, meas_dim):
        self.et = et
        self.slot_dims = slot_dims
        self.dtot = int(sum(slot_dims))
        self.res_dim = res_dim
        self.n = 0
        cap = 64
        a = et.arity
        self.rows = np.zeros((cap, a), np.int64)     # row in per-vtype arrays
        self.offs = np.zeros((cap, a), np.int64)     # scalar offset (or dump)
        self.meas = np.zeros((cap, meas_dim))
        self.W = np.zeros((cap, res_dim, res_dim))
        self.C = np.zeros((cap, self.dtot, self.dtot))
        self.b = np.zeros((cap, self.dtot))
        self.chi = np.zeros(cap)
        self.hidx = np.zeros((cap, self.dtot * self.dtot), np.int64)
        self.gidx = np.zeros((cap, self.dtot), np.int64)

    def _grow(self, need):
        cap = self.rows.shape[0]
        if need <= cap:
            return
        new = max(need, cap * 2)
        for name in ("rows", "offs", "meas", "W", "C", "b", "chi", "hidx", "gidx"):
            arr = getattr(self, name)
            na = np.zeros((new,) + arr.shape[1:], arr.dtype)
            na[:cap] = arr
            setattr(self, name, na)


class FastLSolver(WindowedIncrementalSolver):
    """Resident-system incremental solver (see module docstring).

    Same public surface as WindowedIncrementalSolver: ``incremental_step``
    after each appended edge, ``optimize``/``chi2`` at the end.
    """

    def __init__(self, system: GraphSystem, relin_update_threshold: float = 1e-3,
                 **kw):
        super().__init__(system, **kw)
        # the hot path is many SMALL dense LAPACK calls; threaded OpenBLAS
        # is pathologically slow for 100-600-dim factorizations on small
        # VMs.  Pin BLAS to one thread for the solver's lifetime where
        # threadpoolctl is installed; ``blas_pinned`` says whether it was
        try:
            import threadpoolctl
        except ImportError:
            self._blas_ctx = None
        else:
            self._blas_ctx = threadpoolctl.threadpool_limits(
                limits=1, user_api="blas"
            )
        self.blas_pinned = self._blas_ctx is not None
        self.tail = 0                      # resumed factor replaces tail path
        self.relin_update_threshold = relin_update_threshold
        self._lin_stale = True
        self._synced = True
        self._queue: List[Tuple[str, int]] = []   # (edge type, system index)
        self._edge_seen_t: Dict[str, int] = {}
        # resident system (built on first solve)
        self._capF = 0
        self._H: Optional[np.ndarray] = None
        self._g: Optional[np.ndarray] = None
        self._Lf: Optional[np.ndarray] = None
        self._N = 0
        self._dirtyc = 0                   # first dirty scalar column
        self._slot_of: Dict[int, int] = {}
        self._slot_vid: List[int] = []
        self._slot_off: List[int] = []
        self._slot_vt: List[str] = []
        self._vt_lin: Dict[str, np.ndarray] = {}
        self._vt_cur: Dict[str, np.ndarray] = {}
        self._vt_offs: Dict[str, np.ndarray] = {}
        self._vt_syslocal: Dict[str, List[int]] = {}
        self._vt_n: Dict[str, int] = {}
        self._slot_vtrow: List[Tuple[str, int]] = []
        self._E: Dict[str, _EdgeStore] = {}
        self._incident: Dict[int, List[Tuple[str, int]]] = {}
        self._jitter = 0.0
        self.n_full_factor = 0
        self.n_resumed_factor = 0
        self._rvm: Optional[Dict[str, List[int]]] = None
        self._rvm_len = -1
        self._sys_incident: Dict[int, List[Tuple[str, int]]] = {}
        self._frozen_ver = 0
        self._slots_ver = 0
        self._pr_cache = None
        self._sep_cache = None

    def _edge_lin_fn(self, tname: str):
        return _np_kernel(NP_EDGE_LIN, adapter.make_edge_lin, tname)

    def _retract_fn(self, tname: str):
        return _np_kernel(NP_RETRACT, adapter.make_retract, tname)

    def _ldiff_fn(self, tname: str):
        return _np_kernel(NP_LOCAL_DIFF, adapter.make_local_diff, tname)

    # ------------------------------------------------------------- state views
    def _cur_state(self, vid: int) -> np.ndarray:
        s = self._slot_of.get(vid)
        if s is not None and self._H is not None:
            t, r = self._slot_vtrow[s]
            return self._vt_cur[t][r]
        return self.system.vertex_state(vid)

    def _sync_states_to_system(self) -> None:
        if self._synced or self._H is None:
            return
        vst = self.system._vstates
        for t, cur in self._vt_cur.items():
            lst = vst[t]
            for r, local in enumerate(self._vt_syslocal[t]):
                lst[local] = cur[r].copy()
        self._synced = True

    # --------------------------------------------------------------- step flow
    def _new_edges_full(self):
        out = []
        for tname in self.system.edge_type_names:
            rec = self.system._edges[tname]
            seen = self._edge_seen_t.get(tname, 0)
            for e in range(seen, len(rec["vids"])):
                vids = rec["vids"][e]
                out.append((tname, e, vids))
                for v in vids:
                    self._sys_incident.setdefault(v, []).append((tname, e))
            self._edge_seen_t[tname] = len(rec["vids"])
        return out

    def _chunk_edges(self, interiors):
        """Edges owned by a chunk, via the maintained vid->edges map —
        O(chunk * degree) instead of the parent's O(total edges) scan."""
        seen = set()
        out = []
        for v in interiors:
            for key in self._sys_incident.get(v, ()):
                if key not in seen:
                    seen.add(key)
                    tname, e = key
                    out.append((tname, e, self.system._edges[tname]["vids"][e]))
        return out

    def incremental_step(self, edge_vertex_ids=None) -> bool:
        """As the windowed solver's; newly appended edges are always
        discovered from the system."""
        self.n_steps += 1
        new_edges = self._new_edges_full()
        for tname, e, vids in new_edges:
            new = [v for v in vids if v not in self._known_vids]
            self._known_vids.update(vids)
            if not new:
                self._had_loop_closure = True
            for v in vids:
                if v in self._frozen_of:
                    self._sync_states_to_system()
                    self._promote_and_refreeze(v)
            self._queue.append((tname, e))

        n_new = self.system.n_vertices - self._verts_at_last_solve
        if n_new < self.solve_period:
            return False
        if len(self._active_ids()) > self.window + self.chunk:
            self._sync_states_to_system()
            self._maybe_freeze()
        if self.require_loop_closure and not self._had_loop_closure:
            self._verts_at_last_solve = self.system.n_vertices
            return False
        self._solve()
        self._verts_at_last_solve = self.system.n_vertices
        self._had_loop_closure = False
        return True

    # ----------------------------------------------------------- chunk freeze
    def _freeze_chunk(self, interior_ids: List[int]) -> None:
        """NumPy chunk elimination (parent semantics, no device dispatch,
        vectorized per edge type).

        Reference analog: eliminating the out-of-window columns of R at
        their current linearization (NonlinearSolver_FastL.h:954)."""
        interiors = set(interior_ids)
        edges = self._chunk_edges(interiors)
        bnd = sorted(
            {v for _, _, vids in edges for v in vids if v not in interiors},
            key=self._sep_rank.get,
        )
        order = list(interior_ids) + bnd
        offs: Dict[int, int] = {}
        off = 0
        for v in order:
            t, _ = self.system.vertex_index[v]
            offs[v] = off
            off += get_vertex_type(t).dim
            if self._bs is None:
                self._bs = get_vertex_type(t).dim
        n = off
        H = np.zeros((n, n))
        g = np.zeros(n)
        states = {v: np.asarray(self._cur_state(v), float) for v in order}
        by_type: Dict[str, List[Tuple[int, list]]] = {}
        for tname, e, vids in edges:
            by_type.setdefault(tname, []).append((e, vids))
        for tname, items in by_type.items():
            et = get_edge_type(tname)
            rec = self.system._edges[tname]
            E = len(items)
            slot_states = tuple(
                np.stack([states[vids[a]] for _, vids in items])
                for a in range(et.arity)
            )
            meas = np.stack([rec["meas"][e] for e, _ in items])
            W = np.stack([rec["sigma_inv"][e] for e, _ in items])
            r, jacs = self._edge_lin_fn(tname)(slot_states, meas)
            Wr = np.einsum("eij,ej->ei", W, r)
            WJ = [np.einsum("eij,ejk->eik", W, jacs[a]) for a in range(et.arity)]
            offv = np.array(
                [[offs[vids[a]] for a in range(et.arity)] for _, vids in items],
                np.int64,
            )
            Hf = H.ravel()
            for a in range(et.arity):
                da = jacs[a].shape[2]
                ga = np.einsum("eij,ei->ej", WJ[a], r)
                rows = offv[:, a, None] + np.arange(da)[None, :]
                np.add.at(g, rows.ravel(), ga.ravel())
                for bslot in range(et.arity):
                    db = jacs[bslot].shape[2]
                    Hab = np.einsum("eij,eik->ejk", jacs[a], WJ[bslot])
                    cols = offv[:, bslot, None] + np.arange(db)[None, :]
                    fl = (rows[:, :, None] * n + cols[:, None, :]).ravel()
                    np.add.at(Hf, fl, Hab.ravel())
        if self.system._unary_anchor in interiors:
            oa = offs[self.system._unary_anchor]
            t, _ = self.system.vertex_index[self.system._unary_anchor]
            da = get_vertex_type(t).dim
            H[np.arange(oa, oa + da), np.arange(oa, oa + da)] += (
                self.system.unary_information
            )
        bs = self._bs
        ni = sum(
            get_vertex_type(self.system.vertex_index[v][0]).dim
            for v in interior_ids
        )
        A = H[:ni, :ni]
        U = H[:ni, ni:]
        Hss = H[ni:, ni:]
        gi, gsv = g[:ni], g[ni:]
        L = np.linalg.cholesky(A + 1e-12 * np.eye(ni))
        WU = solve_triangular(L, U, lower=True, check_finite=False)
        y = solve_triangular(L, gi, lower=True, check_finite=False)
        contrib_sc = Hss - WU.T @ WU
        contrib_rhs = gsv - WU.T @ y
        bnd_ranks = np.array([self._sep_rank[v] for v in bnd], np.int64)
        rec = dict(
            ids=list(interior_ids), bnd=bnd, bnd_ranks=bnd_ranks,
            L=L, WU=WU, y=y, contrib_sc=contrib_sc, contrib_rhs=contrib_rhs,
            lin_states={v: states[v].copy() for v in interior_ids},
            bnd_states={v: states[v].copy() for v in bnd},
        )
        ci = len(self.frozen)
        self.frozen.append(rec)
        for v in interior_ids:
            self._frozen_of[v] = ci
        self._sc_accumulate(rec, +1.0)

    def _sc_accumulate(self, rec, sign):
        """Parent bookkeeping plus the in-place prior delta into the live H:
        a refreeze (promote / fluid relinearization) only changes the Schur
        prior at separator slots — no membership change, so the resident
        system absorbs it and the factor resumes from the first separator
        column instead of rebuilding (FastL's omega-update economics,
        NonlinearSolver_FastL.h:818)."""
        super()._sc_accumulate(rec, sign)
        self._frozen_ver += 1
        if self._H is None or self._lin_stale or not len(rec["bnd_ranks"]):
            return
        bs = self._bs
        base = []
        for rank in rec["bnd_ranks"]:
            v = self.sep_ids[int(rank)]
            slot = self._slot_of.get(v)
            if slot is None:
                self._lin_stale = True
                return
            base.append(self._slot_off[slot])
        iscal = (np.asarray(base, np.int64)[:, None] + np.arange(bs)[None, :]).ravel()
        self._H[np.ix_(iscal, iscal)] += sign * rec["contrib_sc"]
        self._dirtyc = min(self._dirtyc, int(iscal.min()))

    def _freeze_oldest(self):
        # a NEW chunk removes interiors from the live set: rebuild required
        super()._freeze_oldest()
        self._lin_stale = True

    def _promote_and_refreeze(self, vid: int) -> None:
        # give the promoted vertex a live slot up front so the refrozen
        # chunk's prior delta can be applied in place (no rebuild)
        if self._H is not None and not self._lin_stale and vid not in self._slot_of:
            t = self.system.vertex_index[vid][0]
            if self._N + get_vertex_type(t).dim <= self._capF:
                self._add_slot(vid)
            else:
                self._lin_stale = True
        super()._promote_and_refreeze(vid)

    # -------------------------------------------------------- resident system
    def _add_slot(self, vid: int) -> None:
        t, local = self.system.vertex_index[vid]
        vt = get_vertex_type(t)
        s = len(self._slot_vid)
        self._slot_of[vid] = s
        self._slot_vid.append(vid)
        self._slot_off.append(self._N)
        self._slot_vt.append(t)
        nrow = self._vt_n.get(t, 0)
        arr = self._vt_lin.get(t)
        if arr is None or nrow >= arr.shape[0]:
            cap = max(64, (arr.shape[0] * 2) if arr is not None else 64)
            for d in (self._vt_lin, self._vt_cur):
                na = np.zeros((cap, vt.state_dim))
                if arr is not None:
                    na[:nrow] = d[t][:nrow]
                d[t] = na
            no = np.zeros(cap, np.int64)
            if t in self._vt_offs:
                no[:nrow] = self._vt_offs[t][:nrow]
            self._vt_offs[t] = no
        st = np.asarray(self.system.vertex_state(vid), float)
        self._vt_lin[t][nrow] = st
        self._vt_cur[t][nrow] = st
        self._vt_offs[t][nrow] = self._N
        self._vt_syslocal.setdefault(t, []).append(local)
        self._vt_n[t] = nrow + 1
        self._slot_vtrow.append((t, nrow))
        self._incident.setdefault(vid, [])
        if vid in self._sep_rank:
            self._slots_ver += 1   # a separator gained a live slot
        self._dirtyc = min(self._dirtyc, self._N)
        self._N += vt.dim

    def _edge_store(self, tname: str) -> _EdgeStore:
        es = self._E.get(tname)
        if es is None:
            et = get_edge_type(tname)
            dims = tuple(get_vertex_type(v).dim for v in et.vertex_types)
            es = _EdgeStore(et, dims, et.res_dim, et.meas_dim)
            self._E[tname] = es
        return es

    def _lin_edges(self, tname: str, idx: np.ndarray) -> None:
        """(Re)linearize edges ``idx`` of type ``tname`` at the current lin
        points, replacing their cached contributions in H and g (vectorized)."""
        es = self._E[tname]
        et = es.et
        rows = es.rows[idx]
        slot_states = tuple(
            self._vt_lin[et.vertex_types[a]][rows[:, a]] for a in range(et.arity)
        )
        r, jacs = self._edge_lin_fn(tname)(slot_states, es.meas[idx])
        W = es.W[idx]
        Wr = np.einsum("eij,ej->ei", W, r)
        dims = es.slot_dims
        dtot = es.dtot
        E = idx.shape[0]
        C = np.empty((E, dtot, dtot))
        b = np.empty((E, dtot))
        o = 0
        WJ = [np.einsum("eij,ejk->eik", W, jacs[a]) for a in range(et.arity)]
        for a in range(et.arity):
            da = dims[a]
            b[:, o : o + da] = np.einsum("eij,ei->ej", WJ[a], r)
            o2 = 0
            for bb in range(et.arity):
                db = dims[bb]
                C[:, o : o + da, o2 : o2 + db] = np.einsum(
                    "eij,eik->ejk", jacs[a], WJ[bb]
                )
                o2 += db
            o += da
        chi = np.einsum("ei,ei->e", r, Wr)
        dC = C - es.C[idx]
        db_ = b - es.b[idx]
        Hf = self._H.ravel()
        np.add.at(Hf, es.hidx[idx].ravel(), dC.ravel())
        np.add.at(self._g, es.gidx[idx].ravel(), db_.ravel())
        es.C[idx] = C
        es.b[idx] = b
        es.chi[idx] = chi
        real = es.offs[idx]
        rmin = real[real < self._capF].min() if (real < self._capF).any() else self._N
        self._dirtyc = min(self._dirtyc, int(rmin))

    def _insert_edge(self, tname: str, e: int) -> None:
        rec = self.system._edges[tname]
        vids = rec["vids"][e]
        for v in vids:
            if v in self._frozen_of:
                # closure into a frozen interior: handled by promote before
                # solve; if it still appears here the system must rebuild
                self._lin_stale = True
                return
            if v not in self._slot_of and not self.system._vconst.get(v, False):
                if self._N + get_vertex_type(self.system.vertex_index[v][0]).dim > self._capF:
                    self._lin_stale = True
                    return
                self._add_slot(v)
        es = self._edge_store(tname)
        i = es.n
        es._grow(i + 1)
        es.n = i + 1
        es.meas[i] = np.asarray(rec["meas"][e])
        es.W[i] = np.asarray(rec["sigma_inv"][e])
        a = es.et.arity
        for sslot in range(a):
            v = vids[sslot]
            if self.system._vconst.get(v, False):
                es.rows[i, sslot] = 0
                es.offs[i, sslot] = self._capF   # dump band
            else:
                s = self._slot_of[v]
                t, rrow = self._slot_vtrow[s]
                es.rows[i, sslot] = rrow
                es.offs[i, sslot] = self._slot_off[s]
                self._incident[v].append((tname, i))
        # flat H / g indices for this edge's stacked block
        offv = np.concatenate(
            [es.offs[i, k] + np.arange(es.slot_dims[k]) for k in range(a)]
        )
        stride = self._H.shape[1]
        es.hidx[i] = (offv[:, None] * stride + offv[None, :]).ravel()
        es.gidx[i] = offv
        self._lin_edges(tname, np.array([i]))

    def _rebuild_linsys(self) -> None:
        """Full rebuild of the resident live system from the graph (freeze /
        promote / relinearization events; rare)."""
        with self.timer.phase("rebuild"):
            self._sync_states_to_system()
            frozen = self._frozen_of
            live = [v for v in self.system._vorder if v not in frozen]
            ndim = sum(
                get_vertex_type(self.system.vertex_index[v][0]).dim for v in live
            )
            dmax = max(
                (get_vertex_type(t).dim for t in self.system.vertex_type_names),
                default=3,
            )
            capF = max(512, -(-int(ndim + 64 * dmax + dmax) // 128) * 128)
            self._capF = capF
            self._slots_ver += 1
            self._H = np.zeros((capF + dmax, capF + dmax))
            self._g = np.zeros(capF + dmax)
            self._Lf = np.zeros((capF, capF), order="F")
            dpad = np.arange(capF)
            self._Lf[dpad, dpad] = 1.0   # unit rows for the padding region
            self._N = 0
            self._dirtyc = 0
            self._slot_of = {}
            self._slot_vid = []
            self._slot_off = []
            self._slot_vt = []
            self._slot_vtrow = []
            self._vt_lin = {}
            self._vt_cur = {}
            self._vt_offs = {}
            self._vt_syslocal = {}
            self._vt_n = {}
            self._E = {}
            self._incident = {}
            self._rvm = None
            self._rvm_len = -1
            for v in live:
                self._add_slot(v)
            # batched insert: store rows/offs then one vectorized lin per type
            for tname in self.system.edge_type_names:
                rec = self.system._edges[tname]
                es = self._edge_store(tname)
                keep = [
                    e for e, vids in enumerate(rec["vids"])
                    if not any(v in frozen for v in vids)
                ]
                if not keep:
                    continue
                es._grow(len(keep))
                a = es.et.arity
                stride = self._H.shape[1]
                for i, e in enumerate(keep):
                    vids = rec["vids"][e]
                    es.meas[i] = np.asarray(rec["meas"][e])
                    es.W[i] = np.asarray(rec["sigma_inv"][e])
                    for sslot in range(a):
                        v = vids[sslot]
                        if self.system._vconst.get(v, False):
                            es.rows[i, sslot] = 0
                            es.offs[i, sslot] = self._capF
                        else:
                            s = self._slot_of[v]
                            t, rrow = self._slot_vtrow[s]
                            es.rows[i, sslot] = rrow
                            es.offs[i, sslot] = self._slot_off[s]
                            self._incident[v].append((tname, i))
                    offv = np.concatenate(
                        [es.offs[i, k] + np.arange(es.slot_dims[k]) for k in range(a)]
                    )
                    es.hidx[i] = (offv[:, None] * stride + offv[None, :]).ravel()
                    es.gidx[i] = offv
                es.n = len(keep)
                es.C[: es.n] = 0.0
                es.b[: es.n] = 0.0
                self._lin_edges(tname, np.arange(es.n))
            # unary gauge factor
            anchor = self.system._unary_anchor
            if anchor is not None and anchor in self._slot_of:
                s = self._slot_of[anchor]
                t = self._slot_vt[s]
                da = get_vertex_type(t).dim
                o = self._slot_off[s]
                self._H[np.arange(o, o + da), np.arange(o, o + da)] += (
                    self.system.unary_information
                )
            # frozen-chunk Schur prior Hessian into separator slots
            sep_scal = self._sep_scalars()
            n0 = self._sc.shape[0]
            if n0 and sep_scal is not None:
                sel = sep_scal[:n0]
                ok = sel >= 0
                ii = sel[ok]
                self._H[np.ix_(ii, ii)] += self._sc[np.ix_(ok, ok)]
            self._lin_stale = False
            self._synced = True
            self._queue = []
            self._jitter = 0.0
            self._full_factor()

    def _sep_scalars(self) -> Optional[np.ndarray]:
        """Scalar offset of each separator rank's block start, -1 if the
        separator vertex is not live — in self.sep_ids (rank) order, expanded
        to bs-wide scalar indices.  Cached; separators and slots are
        append-only between rebuilds."""
        bs = self._bs
        if bs is None or not self.sep_ids:
            return None
        key = (len(self.sep_ids), self._slots_ver)
        if self._sep_cache is not None and self._sep_cache[0] == key:
            return self._sep_cache[1]
        out = np.full(len(self.sep_ids) * bs, -1, np.int64)
        for rank, v in enumerate(self.sep_ids):
            s = self._slot_of.get(v)
            if s is not None:
                out[rank * bs : (rank + 1) * bs] = self._slot_off[s] + np.arange(bs)
        self._sep_cache = (key, out)
        return out

    # ---------------------------------------------------------------- factor
    def _chol(self, A: np.ndarray) -> np.ndarray:
        """Lower Cholesky via LAPACK dpotrf (A is a fresh scratch array and
        is overwritten); escalating-jitter fallback on indefiniteness."""
        c, info = dpotrf(A, lower=1, overwrite_a=1, clean=1)
        if info == 0:
            return c
        j = max(self._jitter * 100, 1e-9) * max(1.0, float(np.max(np.diag(A))))
        self._jitter = j
        return np.linalg.cholesky(A + j * np.eye(A.shape[0]))

    def _full_factor(self) -> None:
        # the strict upper triangle of Lf is never read (dtrtrs lower=1),
        # and padding rows keep their unit diagonal from rebuild time — only
        # the leading block needs writing.  F-order copy + clean=0 keeps
        # dpotrf copy-free (~3x faster than the naive path).
        n = self._N
        A = np.asfortranarray(self._H[:n, :n])
        d = np.arange(n)
        A[d, d] += _JITTER0 + self._jitter * np.maximum(1.0, A[d, d])
        c, info = dpotrf(A, lower=1, overwrite_a=1, clean=0)
        if info != 0:
            self._jitter = max(self._jitter * 100, 1e-9)
            A = np.asfortranarray(self._H[:n, :n])
            A[d, d] += _JITTER0 + self._jitter * np.maximum(1.0, A[d, d])
            c = np.linalg.cholesky(A)
        self._Lf[:n, :n] = c
        self._dirtyc = self._N
        self.n_full_factor += 1

    # past this trailing width a fresh dpotrf beats the resumed path (the
    # strided L21 gemm dominates; measured crossover ~50-150 columns)
    _RESUME_MAX = 64

    def _factor(self) -> None:
        n = self._N
        d = self._dirtyc
        if d >= n:
            return
        if d == 0 or n - d > self._RESUME_MAX:
            with self.timer.phase("full_factor"):
                self._full_factor()
            return
        with self.timer.phase("resumed_factor"):
            # columns < d unchanged; rows >= d of those columns unchanged for
            # old rows and identically zero for appended rows (edge inserts
            # mark dirty <= their lowest touched column, so H[:d, new] == 0)
            L21 = self._Lf[d:n, :d]
            S = self._H[d:n, d:n] - L21 @ L21.T
            S[np.arange(n - d), np.arange(n - d)] += _JITTER0
            self._Lf[d:n, d:n] = self._chol(S)
            self._dirtyc = n
            self.n_resumed_factor += 1

    def _prior_plan(self):
        """Cached vectorization plan for the prior drift: one batched
        local_diff per vertex type + one small matvec per frozen chunk."""
        ver = (self._frozen_ver, self._slots_ver)
        if self._pr_cache is not None and self._pr_cache[0] == ver:
            return self._pr_cache[1]
        bs = self._bs
        by_t: Dict[str, list] = {}
        recs = []
        pos = 0
        for rec in self.frozen:
            if not rec["ids"] or not rec["bnd"]:
                continue
            p0 = pos
            live_ok = True
            for v in rec["bnd"]:
                sl = self._slot_of.get(v)
                if sl is None:
                    live_ok = False
                    break
                t, r = self._slot_vtrow[sl]
                by_t.setdefault(t, []).append((r, rec["bnd_states"][v], pos))
                pos += get_vertex_type(t).dim
            if not live_ok:
                self._pr_cache = (ver, None)
                return None
            idx = (
                rec["bnd_ranks"][:, None] * bs + np.arange(bs)[None, :]
            ).ravel()
            recs.append((rec["contrib_sc"], idx, slice(p0, pos)))
        groups = []
        for t, lst in by_t.items():
            rows = np.array([r for r, _, _ in lst], np.int64)
            refs = np.stack([ref for _, ref, _ in lst])
            poss = np.array([p for _, _, p in lst], np.int64)
            groups.append((t, rows, refs, poss, get_vertex_type(t).dim))
        plan = (pos, groups, recs)
        self._pr_cache = (ver, plan)
        return plan

    def _prior_rhs(self) -> Optional[np.ndarray]:
        """Prior gradient at the CURRENT separator lin points:
        sum_k [rhs_k + sc_k (lin [-] freeze_states_k)] in sep-rank coords."""
        bs = self._bs
        if bs is None or not self.frozen or self._sc.shape[0] == 0:
            return None
        out = self._rhs.copy()
        plan = self._prior_plan()
        if plan is None:
            return out
        total, groups, recs = plan
        delta_all = np.empty(total)
        for t, rows, refs, poss, dim in groups:
            d = self._ldiff_fn(t)(self._vt_lin[t][rows], refs)
            delta_all[poss[:, None] + np.arange(dim)[None, :]] = d
        for sc, idx, sl in recs:
            out[idx] += sc @ delta_all[sl]
        return out

    def _cur_lin(self, vid: int) -> np.ndarray:
        s = self._slot_of.get(vid)
        if s is not None:
            t, r = self._slot_vtrow[s]
            return self._vt_lin[t][r]
        return np.asarray(self.system.vertex_state(vid), float)

    # ----------------------------------------------------------------- solve
    def _solve(self) -> None:
        self.n_solves += 1
        if self._lin_stale or self._H is None:
            self._rebuild_linsys()
        else:
            with self.timer.phase("ingest"):
                q, self._queue = self._queue, []
                for tname, e in q:
                    self._insert_edge(tname, e)
                    if self._lin_stale:
                        break
            if self._lin_stale:
                self._rebuild_linsys()
        for _ in range(max(1, self.max_iterations)):
            with self.timer.phase("factor"):
                self._factor()
            with self.timer.phase("backsolve"):
                rhs = -self._g[: self._capF]
                pr = self._prior_rhs()
                if pr is not None:
                    sep_scal = self._sep_scalars()
                    n0 = pr.shape[0]
                    sel = sep_scal[:n0]
                    ok = sel >= 0
                    rhs[sel[ok]] -= pr[ok]
                y, _ = dtrtrs(self._Lf, rhs, lower=1)
                dx, _ = dtrtrs(self._Lf, y, lower=1, trans=1)
            dxn = float(np.linalg.norm(dx[: self._N]))
            if not np.isfinite(dxn):
                # numerical failure: rebuild with jitter (reference LM-style
                # iteration abort, NonlinearSolver_Lambda.h:658)
                self._jitter = max(self._jitter * 100, 1e-9)
                self._lin_stale = True
                return
            with self.timer.phase("apply"):
                moved = self._apply_dx(dx)
            if not moved or dxn < 1e-4:
                break
        if self.verbose:
            print(
                f"fastl #{self.n_solves}: |dx|={dxn:.5f} n={self._N} "
                f"sep={len(self.sep_ids)}"
            )
        self._relinearize_dirty_fast()

    def _apply_dx(self, dx: np.ndarray) -> bool:
        """x = retract(lin, dx) gated by update_threshold; relinearize
        vertices with |dx| > relin_update_threshold.  Returns True when any
        vertex crossed the relinearization gate (another iteration could
        improve)."""
        any_relin = False
        stale: Dict[str, Set[int]] = {}
        for t, nrow in self._vt_n.items():
            if nrow == 0:
                continue
            vt = get_vertex_type(t)
            offs = self._vt_offs[t][:nrow]
            delta = dx[offs[:, None] + np.arange(vt.dim)[None, :]]
            norms = np.linalg.norm(delta, axis=1)
            gate = norms > self.update_threshold
            d_eff = np.where(gate[:, None], delta, 0.0)
            lin = self._vt_lin[t][:nrow]
            cur = self._retract_fn(t)(lin, d_eff)
            self._vt_cur[t][:nrow] = cur
            relin = norms > self.relin_update_threshold
            if relin.any():
                any_relin = True
                self._vt_lin[t][:nrow][relin] = cur[relin]
                rvm = self._row_vid_map(t)
                for r in np.nonzero(relin)[0]:
                    for tname, i in self._incident.get(rvm[r], ()):
                        stale.setdefault(tname, set()).add(i)
        self._synced = False
        if stale:
            with self.timer.phase("relinearize_edges"):
                for tname, idxs in stale.items():
                    self._lin_edges(tname, np.fromiter(idxs, np.int64))
        return any_relin

    def _row_vid_map(self, t: str):
        m = self._rvm
        if m is None:
            m = {}
            self._rvm = m
            self._rvm_len = 0
        n = len(self._slot_vid)
        if self._rvm_len != n:
            for s in range(self._rvm_len, n):   # slots are append-only
                tt, _ = self._slot_vtrow[s]
                m.setdefault(tt, []).append(self._slot_vid[s])
            self._rvm_len = n
        return m[t]

    # ------------------------------------------------- fluid relin of chunks
    def _relinearize_dirty_fast(self) -> None:
        if not self.frozen or self.relin_threshold <= 0:
            return
        bs = self._bs
        dirty = False
        for rec in self.frozen:
            if not rec["ids"]:
                continue
            for v in rec["bnd"]:
                cur = self._cur_state(v)
                if np.max(np.abs(cur[:bs] - rec["bnd_states"][v][:bs])) > self.relin_threshold:
                    dirty = True
                    break
            if dirty:
                break
        if not dirty:
            return
        self._sync_states_to_system()
        super()._relinearize_dirty()

    # --------------------------------------------------------------- refresh
    def refresh_frozen(self) -> None:
        """Back-substitute frozen-interior corrections (parent semantics),
        vectorized: one triangular solve + one batched retract per chunk."""
        self._sync_states_to_system()
        bs = self._bs
        if bs is None or not self.frozen:
            return
        sysidx = self.system.vertex_index
        vst = self.system._vstates
        for rec in self.frozen:
            if not rec["ids"]:
                continue
            dxs_parts = []
            for v in rec["bnd"]:
                t, li = sysidx[v]
                dxs_parts.append(
                    self._ldiff_fn(t)(
                        vst[t][li][None, :], rec["bnd_states"][v][None, :]
                    )[0]
                )
            dxs = np.concatenate(dxs_parts) if dxs_parts else np.zeros(0)
            rhs_i = rec["y"] + (rec["WU"] @ dxs if len(dxs) else 0.0)
            dxi = -solve_triangular(
                rec["L"], rhs_i, lower=True, trans=1, check_finite=False
            )
            by_t: Dict[str, list] = {}
            o = 0
            for v in rec["ids"]:
                t, li = sysidx[v]
                d = get_vertex_type(t).dim
                by_t.setdefault(t, []).append((v, li, o, d))
                o += d
            for t, lst in by_t.items():
                lins = np.stack([rec["lin_states"][v] for v, _, _, _ in lst])
                dd = np.stack([dxi[oo : oo + d] for _, _, oo, d in lst])
                new = self._retract_fn(t)(lins, dd)
                for i, (_, li, _, _) in enumerate(lst):
                    vst[t][li] = new[i]

    def chi2(self) -> float:
        self._sync_states_to_system()
        return super().chi2()

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        self._sync_states_to_system()
        return super().optimize(max_iterations, min_dx_norm)
