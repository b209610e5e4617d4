"""Host (SciPy) linear-solver backend (counterpart of
``slampp_tpu/linear/scipy_solver.py``, the port's own copy).

Capability parity role: the reference's third-party solver backends
(CSparse/CXSparse/CHOLMOD, include/slam/LinearSolver_C*.h) — an independent
elementwise sparse factorization used for cross-checking the native device
solver (SURVEY.md §2.2 explicitly sanctions SciPy in this role) and as a
host solver for graphs whose structure the device solver does not
cover.  Supports cached symbolic factorization like the blockwise API
(splu keeps the permutation; we key the cache on the sparsity pattern).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import sparse as sp
from scipy.sparse import linalg as spla


class ScipySolver:
    """Solve_PosDef / Solve_PosDef_Blocky analog on host CSR data."""

    def __init__(self):
        self._cached_pattern = None
        self._cached_factor = None

    def solve_pos_def(self, H, b: np.ndarray) -> np.ndarray:
        """One-shot SPD solve (CLinearSolver_CSparse::Solve_PosDef analog)."""
        Hc = sp.csc_matrix(H)
        return spla.spsolve(Hc, np.asarray(b, float))

    def symbolic_decomposition(self, H) -> None:
        """Cache the factorization of this pattern (SymbolicDecomposition_Blocky)."""
        Hc = sp.csc_matrix(H)
        self._cached_pattern = (Hc.indptr.tobytes(), Hc.indices.tobytes())
        self._cached_factor = spla.splu(Hc)

    def solve_pos_def_blocky(self, H, b: np.ndarray) -> np.ndarray:
        """Solve reusing the cached symbolic/numeric factorization when the
        pattern matches; refactor numerics otherwise."""
        Hc = sp.csc_matrix(H)
        pat = (Hc.indptr.tobytes(), Hc.indices.tobytes())
        if self._cached_pattern != pat:
            self.symbolic_decomposition(Hc)
        else:
            self._cached_factor = spla.splu(Hc)
        return self._cached_factor.solve(np.asarray(b, float))
