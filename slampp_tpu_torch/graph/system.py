"""Host-side factor-graph container and device snapshots (counterpart of
``slampp_tpu/graph/system.py``).

``GraphSystem`` is the JAX package's host pools in NumPy: typed vertex/edge
pools with O(1) id access, lazy vertex initialization from the first
referencing edge, const vertices, and the automatic unary (gauge) factor
anchored by the first edge (reference CFlatSystem, FlatSystem.h:1915).
``snapshot(device)`` freezes it into :class:`GraphArrays` of torch tensors:
float64 states, measurements and information matrices, int64 indices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from slampp_tpu_torch.graph.types import get_edge_type, get_vertex_type

F64 = torch.float64


@dataclasses.dataclass
class EdgeArrays:
    """Device-side SoA for one edge type."""

    local_idx: torch.Tensor  # (E, arity) int64 local index in each slot's type pool
    offsets: torch.Tensor  # (E, arity) int64 scalar offset (state_dim = const)
    meas: torch.Tensor  # (E, meas_dim) float64
    sigma_inv: torch.Tensor  # (E, res_dim, res_dim) float64 information
    valid: torch.Tensor  # (E,) bool

    def to(self, device) -> "EdgeArrays":
        return EdgeArrays(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass
class GraphArrays:
    """Frozen device snapshot of the whole graph.

    ``states[t]`` is (n_t, state_dim_t) float64; ``vertex_offsets[t]`` is
    (n_t,) scalar offsets into the global state vector (``state_dim`` for
    const vertices, the dummy slot)."""

    states: Dict[str, torch.Tensor]
    vertex_offsets: Dict[str, torch.Tensor]
    edges: Dict[str, EdgeArrays]
    state_dim: int
    unary_offset: int
    unary_dim: int
    unary_information: float

    @property
    def device(self) -> torch.device:
        return next(iter(self.states.values())).device

    def to(self, device) -> "GraphArrays":
        return GraphArrays(
            {k: v.to(device) for k, v in self.states.items()},
            {k: v.to(device) for k, v in self.vertex_offsets.items()},
            {k: v.to(device) for k, v in self.edges.items()},
            self.state_dim, self.unary_offset, self.unary_dim, self.unary_information,
        )

    def replace_states(self, new_states: Dict[str, torch.Tensor]) -> "GraphArrays":
        return dataclasses.replace(self, states=new_states)


class GraphSystem:
    """The optimized graph (reference: CFlatSystem, FlatSystem.h:1915).

    Vertices are identified by integer ids (dataset ids); each belongs to one
    registered vertex type.  Edges reference vertices by id and are stored
    per edge type in insertion order.
    """

    def __init__(self, unary_information: float = 1.0):
        self._vstates: Dict[str, List[np.ndarray]] = {}
        self._vids: Dict[str, List[int]] = {}
        self.vertex_index: Dict[int, Tuple[str, int]] = {}  # vid -> (type, local)
        self._vconst: Dict[int, bool] = {}
        # insertion order of free vertex ids (sets the scalar offsets)
        self._vorder: List[int] = []
        self._edges: Dict[str, dict] = {}
        self._edge_count = 0
        self.unary_information = unary_information
        self._unary_anchor: Optional[int] = None

    # ------------------------------------------------------------------ build
    def add_vertex(self, type_name: str, vid: int, state, const: bool = False) -> int:
        if vid in self.vertex_index:
            t, i = self.vertex_index[vid]
            if t != type_name:
                raise ValueError(f"vertex {vid} already exists with type {t}, not {type_name}")
            return i
        vt = get_vertex_type(type_name)
        state = np.asarray(state, dtype=np.float64).reshape(vt.state_dim)
        lst = self._vstates.setdefault(type_name, [])
        ids = self._vids.setdefault(type_name, [])
        local = len(lst)
        lst.append(state)
        ids.append(vid)
        self.vertex_index[vid] = (type_name, local)
        self._vconst[vid] = const
        if not const:
            self._vorder.append(vid)
        return local

    def has_vertex(self, vid: int) -> bool:
        return vid in self.vertex_index

    def vertex_state(self, vid: int) -> np.ndarray:
        t, i = self.vertex_index[vid]
        return self._vstates[t][i]

    def set_vertex_state(self, vid: int, state) -> None:
        t, i = self.vertex_index[vid]
        self._vstates[t][i] = np.asarray(state, dtype=np.float64).reshape(-1)

    def add_edge(
        self,
        type_name: str,
        vertex_ids,
        meas,
        sigma_inv,
        initializers: Optional[Tuple[Optional[Callable], ...]] = None,
    ) -> None:
        """Append an edge, lazily initializing missing vertices with
        ``initializers[slot](known_states, meas)`` (default zeros)."""
        et = get_edge_type(type_name)
        if len(vertex_ids) != et.arity:
            raise ValueError(f"edge {type_name} expects {et.arity} vertices")
        meas = np.asarray(meas, dtype=np.float64).reshape(et.meas_dim)
        sigma_inv = np.asarray(sigma_inv, dtype=np.float64).reshape(et.res_dim, et.res_dim)

        known = {
            s: self.vertex_state(v) for s, v in enumerate(vertex_ids) if self.has_vertex(v)
        }
        for slot, vid in enumerate(vertex_ids):
            if not self.has_vertex(vid):
                vt_name = et.vertex_types[slot]
                vt = get_vertex_type(vt_name)
                init = initializers[slot] if initializers else None
                state = init(known, meas) if init is not None else np.zeros(vt.state_dim)
                self.add_vertex(vt_name, vid, state)
                known[slot] = self.vertex_state(vid)

        rec = self._edges.setdefault(type_name, {"vids": [], "meas": [], "sigma_inv": []})
        rec["vids"].append(list(vertex_ids))
        rec["meas"].append(meas)
        rec["sigma_inv"].append(sigma_inv)
        self._edge_count += 1
        if self._unary_anchor is None:
            # the reference anchors the unary factor on vertex 0 of the first
            # edge (FlatSystem.h:337,432,2653), else on its first vertex
            self._unary_anchor = 0 if 0 in vertex_ids else vertex_ids[0]

    # ----------------------------------------------------------------- layout
    @property
    def n_vertices(self) -> int:
        return len(self.vertex_index)

    @property
    def n_edges(self) -> int:
        return self._edge_count

    def edge_count(self, type_name: str) -> int:
        """Edges of one type (0 for a type the graph does not hold)."""
        rec = self._edges.get(type_name)
        return len(rec["vids"]) if rec else 0

    @property
    def edge_type_names(self) -> List[str]:
        return sorted(self._edges.keys())

    @property
    def vertex_type_names(self) -> List[str]:
        return sorted(self._vstates.keys())

    def _layout(self):
        """Scalar offsets per free vertex (insertion order), total dimension."""
        offsets: Dict[int, int] = {}
        cursor = 0
        for vid in self._vorder:
            t, _ = self.vertex_index[vid]
            offsets[vid] = cursor
            cursor += get_vertex_type(t).dim
        return offsets, cursor

    @property
    def state_dim(self) -> int:
        return self._layout()[1]

    def chi2_dof(self) -> int:
        """Degrees of freedom: the edges' residual dimensions less the
        state dimension, at least 1 (for a normalized chi2)."""
        m = sum(get_edge_type(t).res_dim * len(rec["vids"]) for t, rec in self._edges.items())
        return max(1, m - self.state_dim)

    def update_states(self, new_states) -> None:
        """Write states (tensors on any device, or NumPy arrays) back into
        the host pools."""
        for t, arr in new_states.items():
            if isinstance(arr, torch.Tensor):
                arr = arr.detach().cpu().numpy()
            arr = np.asarray(arr, dtype=np.float64)
            lst = self._vstates[t]
            for i in range(len(lst)):
                lst[i] = arr[i].copy()

    # --------------------------------------------------------------- snapshot
    def snapshot(self, device="cuda") -> GraphArrays:
        """Freeze the graph into tensors on ``device``."""
        offsets, total = self._layout()
        dummy = total  # offset of const vertices

        states: Dict[str, torch.Tensor] = {}
        vertex_offsets: Dict[str, torch.Tensor] = {}
        for t in self.vertex_type_names:
            arr = np.stack(self._vstates[t])
            offs = np.array([offsets.get(v, dummy) for v in self._vids[t]], np.int64)
            states[t] = torch.as_tensor(arr, dtype=F64, device=device)
            vertex_offsets[t] = torch.as_tensor(offs, device=device)

        # vertex id -> (local index, scalar offset), looked up per edge slot
        ids = np.fromiter(self.vertex_index, np.int64, len(self.vertex_index))
        id_order = np.argsort(ids)
        ids_sorted = ids[id_order]
        local_of = np.fromiter((i for _, i in self.vertex_index.values()), np.int64,
                               len(ids))[id_order]
        off_of = np.fromiter((offsets.get(v, dummy) for v in self.vertex_index), np.int64,
                             len(ids))[id_order]
        edges: Dict[str, EdgeArrays] = {}
        for t in self.edge_type_names:
            rec = self._edges[t]
            vids = np.asarray(rec["vids"], np.int64)
            pos = np.searchsorted(ids_sorted, vids)
            local, offs = local_of[pos], off_of[pos]
            edges[t] = EdgeArrays(
                torch.as_tensor(local, device=device),
                torch.as_tensor(offs, device=device),
                torch.as_tensor(np.stack(rec["meas"]), dtype=F64, device=device),
                torch.as_tensor(np.stack(rec["sigma_inv"]), dtype=F64, device=device),
                torch.ones(len(vids), dtype=torch.bool, device=device),
            )

        if self._unary_anchor is not None and not self._vconst.get(self._unary_anchor, False):
            uo = offsets.get(self._unary_anchor, dummy)
            ud = get_vertex_type(self.vertex_index[self._unary_anchor][0]).dim
        else:
            uo, ud = dummy, 0
        return GraphArrays(states, vertex_offsets, edges, total, uo, ud,
                           self.unary_information)
