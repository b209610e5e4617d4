"""Marginal covariance recovery (counterpart of
``slampp_tpu/marginals/marginals.py``).

Capability parity with ``CMarginals`` (include/slam/Marginals.h:70):
  * the dense reference algorithm (Calculate_DenseMarginals_Ref :81) — the
    full Sigma = lambda^-1 through a Cholesky factor;
  * selected columns (the -dm policy masks, IncrementalPolicy.h:398);
  * the incremental block-diagonal update from new-edge information
    (IJRR'17, Update_BlockDiagonalMarginals_FBS :4548), here the exact
    Woodbury downdate on the host, with the b_PreferIncremental cost model
    (:5073) choosing between it and a batch recompute;
  * the recursive sparse algorithm on the block factor (ICRA'15,
    marginals/sparse_marginals.py) through the v2 engine;
  * the CMarginalCovariance cache (:6914): an edge-count watermark and a
    can-update flag.

The JAX package computes the dense path with ``lax.linalg`` outside any
Pallas kernel, so the library calls are the port.  ``lax.linalg.cholesky``
returns NaN for a matrix that is not positive definite, where
``torch.linalg.cholesky`` raises: the factor comes from ``cholesky_ex`` and
a failed factorization gives NaN, as in JAX.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch

from slampp_tpu_torch.core import assembly, block_assembly, sparse_chol2
from slampp_tpu_torch.graph.system import GraphSystem
from slampp_tpu_torch.graph.types import get_vertex_type
from slampp_tpu_torch.utils.device import require_device


def cholesky_nan(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``H``; all NaN where it fails (the
    result of ``lax.linalg.cholesky``)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info == 0, L, torch.nan)


def _solve_factored(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X = (L L^T)^-1 B with two triangular solves."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.T, Y, upper=True)


def dense_marginals(H: torch.Tensor) -> torch.Tensor:
    """Full covariance Sigma = H^-1 (reference Calculate_DenseMarginals_Ref)."""
    return _solve_factored(cholesky_nan(H), torch.eye(H.shape[0], dtype=H.dtype, device=H.device))


def marginals_columns(H: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Selected columns of Sigma (reference _Fast_ColumnBand family): solves
    H X = I[:, cols]; returns (N, len(cols))."""
    m = cols.shape[0]
    E = H.new_zeros(H.shape[0], m)
    E[cols, torch.arange(m, device=H.device)] = 1.0
    return _solve_factored(cholesky_nan(H), E)


def woodbury_blockdiag_downdate(H, Sigma_cols, J, W):
    """Exact block update of Sigma after H' = H + J^T W J (new edges).

    Sigma' = Sigma - U S^-1 U^T with U = Sigma J^T, S = W^-1 + J Sigma J^T.
    ``Sigma_cols``: (N, m) = Sigma J^T precomputed columns; ``J``: (m, N)
    stacked new-edge Jacobian rows; ``W``: (m, m).  Returns the (N, m) U and
    the (m, m) S, so callers can downdate any block they track."""
    return Sigma_cols, torch.linalg.inv(W) + J @ Sigma_cols


class MarginalCovariance:
    """Marginals cache bound to a system (reference CMarginalCovariance,
    Marginals.h:6914): the block-diagonal covariance (host NumPy, per vertex
    id), an edge-count watermark, and a can-update flag cleared when the
    linearization point moves (NonlinearSolver_Lambda.h:655 DisableUpdate).
    The batch recomputes run on ``device``."""

    def __init__(self, system: GraphSystem, device="cuda"):
        self.system = system
        self.device = torch.device(device)
        self.block_diag: Dict[int, np.ndarray] = {}
        self.edge_watermark = 0
        self.can_update = False
        self._H = None

    def update_batch(self) -> None:
        """Full recompute (the reference's batch path): dense H on the
        device, its Cholesky and two triangular solves."""
        require_device(self.device, "MarginalCovariance")
        graph = self.system.snapshot(self.device)
        H, _, _ = assembly.assemble_dense(graph)
        Sigma = dense_marginals(H).cpu().numpy()
        self._H = H.cpu().numpy()
        offsets, _ = self.system._layout()
        self.block_diag = {}
        for vid, off in offsets.items():
            d = get_vertex_type(self.system.vertex_index[vid][0]).dim
            self.block_diag[vid] = Sigma[off : off + d, off : off + d].copy()
        self.edge_watermark = self.system.n_edges
        self.can_update = True

    def update_batch_sparse(self, panel: int = 1) -> None:
        """Recompute the block-diagonal marginals by the RECURSIVE sparse
        algorithm on the v2 factor (the ICRA'15 path,
        Calculate_DenseMarginals_Recurrent_FBS): O(pattern) instead of
        O(N^2); requires a uniform-block graph.  Does not fill the dense
        cache that update_incremental needs."""
        from slampp_tpu_torch.linear.native import NativeBlockSolver
        from slampp_tpu_torch.marginals.sparse_marginals import sparse_marginals, takahashi_plan

        require_device(self.device, "MarginalCovariance")
        graph = self.system.snapshot(self.device)
        ns = NativeBlockSolver(self.system, panel=panel, engine="v2", device=self.device)
        ns.symbolic()
        bp, p2 = ns.block_plan, ns.plan2
        vals, _, _ = block_assembly.assemble_blocks_sorted(graph, bp)
        Ld, Lo = sparse_chol2.factorize2(p2, vals[: p2.n], vals[p2.n : p2.n + p2.n_off])
        Sd, _ = sparse_marginals(p2, takahashi_plan(p2), Ld, Lo)
        Sd = Sd.cpu().numpy()
        offs = bp.dx_offsets.cpu().numpy()
        offsets, _ = self.system._layout()
        by_offset = {off: vid for vid, off in offsets.items()}
        self.block_diag = {}
        for j in range(p2.n):
            for w in range(0, bp.P, bp.bs):
                vid = by_offset.get(int(offs[j, w]))  # None for an unused scalar
                if vid is None:
                    continue
                d = get_vertex_type(self.system.vertex_index[vid][0]).dim
                self.block_diag[vid] = Sd[j][w : w + d, w : w + d]
        self.edge_watermark = self.system.n_edges
        self.can_update = False  # no dense cache for Woodbury updates

    def prefer_incremental(self, n_new_edge_rows: int) -> bool:
        """Cost model (reference b_PreferIncremental, Marginals.h:5073): the
        Woodbury update costs O(N^2 m + m^3), a batch recompute O(N^3)."""
        if not self.can_update or not self.block_diag:
            return False
        N = self.system.state_dim
        m = n_new_edge_rows
        return (N * N * m + m**3) < N**3 / 3

    def update_incremental(self, J: np.ndarray, W: np.ndarray) -> None:
        """Rank update, on the host, after adding edges with stacked
        Jacobians J (m, N) and information W (m, m) at an UNCHANGED
        linearization point.

        On a numerical failure (non-SPD cache, non-finite update) this
        recomputes in batch, as the reference's
        Update_BlockDiagonalMarginals_FBS does on failure
        (NonlinearSolver_Lambda.h:731-741)."""
        if self._H is None:
            raise RuntimeError("update_batch must run before incremental updates")
        try:
            # Sigma J^T through the cached H: one batched solve H X = J^T
            L = np.linalg.cholesky(self._H)
            X = np.linalg.solve(L.T, np.linalg.solve(L, J.T))  # (N, m)
            S = np.linalg.inv(W) + J @ X
            Sinv = np.linalg.inv(S)
            if not (np.all(np.isfinite(X)) and np.all(np.isfinite(Sinv))):
                raise np.linalg.LinAlgError("non-finite incremental update")
        except np.linalg.LinAlgError:
            print(
                "warning: incremental marginals update had a numerical issue: "
                "restarting with the batch recompute instead",
                file=sys.stderr,
            )
            self.update_batch()
            return
        offsets, _ = self.system._layout()
        for vid, off in offsets.items():
            d = get_vertex_type(self.system.vertex_index[vid][0]).dim
            Ub = X[off : off + d]
            self.block_diag[vid] = self.block_diag[vid] - Ub @ Sinv @ Ub.T
        self._H = self._H + J.T @ W @ J
        self.edge_watermark = self.system.n_edges

    def disable_update(self) -> None:
        """The linearization point changed: incremental updates are invalid
        (reference marginals.DisableUpdate)."""
        self.can_update = False
