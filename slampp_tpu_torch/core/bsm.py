"""Public block-sparse matrix container (counterpart of
``slampp_tpu/core/bsm.py``).

Capability parity with the reference's ``CUberBlockMatrix`` public surface
(include/slam/BlockMatrix.h:161) as a library-facing API: append/find blocks,
dense conversion, SpMV, AtA products, scaling/addition, permutation, BSR/CSR
export (BlockMatrixVBR.h analog), MatrixMarket I/O (Save_MatrixMarket), and
sparsity rasterization (Rasterize).

The numeric data is a list of (br, bc) NumPy blocks with a slot table on
the host; ``device_arrays`` packs it as (nnzb, br, bc) tensors.  The host
methods are the JAX package's.  ``ata_device`` and ``multiply_device`` run
the arithmetic on a torch ``device``: the host enumerates the contributing
block pairs (the symbolic phase), the device forms every pair product in
one batched ``einsum`` and sums the products of each destination block with
the grouped segment sums of ``ops/segments.py``.  The solver hot paths do
not go through this class (they use the plans in core/block_assembly.py);
it is the interop, debug and analysis surface.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from slampp_tpu_torch.ops.segments import grouped_segsum_first, plan_grouped_segments


class BlockSparseMatrix:
    """Uniform-block sparse matrix (block rows x block cols of (br, bc))."""

    def __init__(self, n_block_rows: int, n_block_cols: int, br: int, bc: int):
        self.nbr, self.nbc = n_block_rows, n_block_cols
        self.br, self.bc = br, bc
        self._slots: Dict[Tuple[int, int], int] = {}
        self._blocks: list = []

    # ------------------------------------------------------------- structure
    def append_block(self, i: int, j: int, block) -> None:
        """Append_Block (BlockMatrix.h:1211): set/accumulate block (i, j)."""
        block = np.asarray(block, float).reshape(self.br, self.bc)
        s = self._slots.get((i, j))
        if s is None:
            self._slots[(i, j)] = len(self._blocks)
            self._blocks.append(block.copy())
        else:
            self._blocks[s] = self._blocks[s] + block

    def find_block(self, i: int, j: int) -> Optional[np.ndarray]:
        """p_FindBlock (BlockMatrix.h:1118)."""
        s = self._slots.get((i, j))
        return None if s is None else self._blocks[s]

    @property
    def nnz_blocks(self) -> int:
        return len(self._blocks)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nbr * self.br, self.nbc * self.bc)

    def values(self) -> np.ndarray:
        return np.stack(self._blocks) if self._blocks else np.zeros((0, self.br, self.bc))

    def indices(self) -> Tuple[np.ndarray, np.ndarray]:
        ij = np.array(sorted(self._slots, key=self._slots.get), np.int64)
        if len(ij) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return ij[:, 0], ij[:, 1]

    # ------------------------------------------------------------ operations
    def to_dense(self) -> np.ndarray:
        A = np.zeros(self.shape)
        for (i, j), s in self._slots.items():
            A[i * self.br : (i + 1) * self.br, j * self.bc : (j + 1) * self.bc] = self._blocks[s]
        return A

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """SpMV (the PostMultiply family)."""
        x = np.asarray(x, float).reshape(self.nbc, self.bc)
        y = np.zeros((self.nbr, self.br))
        rows, cols = self.indices()
        vals = self.values()
        np.add.at(y, rows, np.einsum("eij,ej->ei", vals, x[cols]))
        return y.reshape(-1)

    def ata(self) -> "BlockSparseMatrix":
        """A^T A (PreMultiplyWithSelfTransposeTo, BlockMatrix.h:2744)."""
        out = BlockSparseMatrix(self.nbc, self.nbc, self.bc, self.bc)
        by_row: Dict[int, list] = {}
        for (i, j), s in self._slots.items():
            by_row.setdefault(i, []).append((j, s))
        for i, entries in by_row.items():
            for ja, sa in entries:
                for jb, sb in entries:
                    if jb < ja:
                        continue
                    out.append_block(ja, jb, self._blocks[sa].T @ self._blocks[sb])
                    if jb != ja:
                        out.append_block(jb, ja, self._blocks[sb].T @ self._blocks[sa])
        return out

    def multiply(self, other: "BlockSparseMatrix") -> "BlockSparseMatrix":
        """GEMM (ProductOf, BlockMatrix.h:2662) — Gustavson row-wise."""
        assert self.nbc == other.nbr and self.bc == other.br
        out = BlockSparseMatrix(self.nbr, other.nbc, self.br, other.bc)
        b_by_row: Dict[int, list] = {}
        for (k, j), s in other._slots.items():
            b_by_row.setdefault(k, []).append((j, s))
        for (i, k), sa in self._slots.items():
            for j, sb in b_by_row.get(k, []):
                out.append_block(i, j, self._blocks[sa] @ other._blocks[sb])
        return out

    # ------------------------------------------------------ device products
    def ata_device(self, device="cuda") -> "BlockSparseMatrix":
        """A^T A on ``device``: batched per-pair block products + one grouped
        segment sum per destination block (PreMultiplyWithSelfTransposeTo,
        BlockMatrix.h:2744-2795).  The host enumerates the contributing
        (slot_a, slot_b) pairs per block row; the device does the
        arithmetic."""
        by_row: Dict[int, list] = {}
        for (i, j), s in self._slots.items():
            by_row.setdefault(i, []).append((j, s))
        sa_l, sb_l, key_l = [], [], []
        for i, entries in by_row.items():
            for ja, sa in entries:
                for jb, sb in entries:
                    sa_l.append(sa)
                    sb_l.append(sb)
                    key_l.append(ja * self.nbc + jb)
        out = BlockSparseMatrix(self.nbc, self.nbc, self.bc, self.bc)
        if not sa_l:
            return out
        vals = _device_values(self, device)
        prods = torch.einsum("eij,eik->ejk", vals[_index(sa_l, device)],
                             vals[_index(sb_l, device)])
        keys, summed = _reduce_by_dest(np.asarray(key_l, np.int64), prods)
        for d, key in enumerate(keys):
            out.append_block(int(key // self.nbc), int(key % self.nbc), summed[d])
        return out

    def multiply_device(self, other: "BlockSparseMatrix", device="cuda") -> "BlockSparseMatrix":
        """GEMM on ``device`` (ProductOf, BlockMatrix.h:2662): host-side
        Gustavson symbolic pass, batched block products and a grouped
        segment sum per destination block on the device."""
        assert self.nbc == other.nbr and self.bc == other.br
        b_by_row: Dict[int, list] = {}
        for (k, j), s in other._slots.items():
            b_by_row.setdefault(k, []).append((j, s))
        sa_l, sb_l, key_l = [], [], []
        for (i, k), sa in self._slots.items():
            for j, sb in b_by_row.get(k, ()):
                sa_l.append(sa)
                sb_l.append(sb)
                key_l.append(i * other.nbc + j)
        out = BlockSparseMatrix(self.nbr, other.nbc, self.br, other.bc)
        if not sa_l:
            return out
        prods = torch.einsum("eij,ejk->eik", _device_values(self, device)[_index(sa_l, device)],
                             _device_values(other, device)[_index(sb_l, device)])
        keys, summed = _reduce_by_dest(np.asarray(key_l, np.int64), prods)
        for d, key in enumerate(keys):
            out.append_block(int(key // other.nbc), int(key % other.nbc), summed[d])
        return out

    def add(self, other: "BlockSparseMatrix", factor: float = 1.0) -> "BlockSparseMatrix":
        """AddTo with factor (BlockMatrix.h:2390)."""
        out = BlockSparseMatrix(self.nbr, self.nbc, self.br, self.bc)
        for (i, j), s in self._slots.items():
            out.append_block(i, j, self._blocks[s])
        for (i, j), s in other._slots.items():
            out.append_block(i, j, factor * other._blocks[s])
        return out

    def scale(self, f: float) -> None:
        for s in range(len(self._blocks)):
            self._blocks[s] = self._blocks[s] * f

    def permute(self, row_perm: np.ndarray, col_perm: np.ndarray) -> "BlockSparseMatrix":
        """Block permutation (Permute_UpperTriangular_To analog, general)."""
        inv_r = np.empty_like(row_perm)
        inv_r[row_perm] = np.arange(len(row_perm))
        inv_c = np.empty_like(col_perm)
        inv_c[col_perm] = np.arange(len(col_perm))
        out = BlockSparseMatrix(self.nbr, self.nbc, self.br, self.bc)
        for (i, j), s in self._slots.items():
            out.append_block(int(inv_r[i]), int(inv_c[j]), self._blocks[s])
        return out

    # ---------------------------------------------------------------- export
    def slice_to(self, r0: int, r1: int, c0: int, c1: int) -> "BlockSparseMatrix":
        """Extract the block sub-matrix [r0:r1) x [c0:c1) (SliceTo,
        BlockMatrix.h:2170 — the reference uses it to carve A/U/C out of
        lambda for the Schur solver)."""
        out = BlockSparseMatrix(r1 - r0, c1 - c0, self.br, self.bc)
        for (i, j), s in self._slots.items():
            if r0 <= i < r1 and c0 <= j < c1:
                out.append_block(i - r0, j - c0, self._blocks[s])
        return out

    def to_bsr(self):
        """BSR export (BlockMatrixVBR.h analog) as scipy.sparse.bsr_matrix."""
        from scipy import sparse as sp

        rows, cols = self.indices()
        order = np.lexsort((cols, rows))
        vals = self.values()[order]
        rows, cols = rows[order], cols[order]
        indptr = np.zeros(self.nbr + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return sp.bsr_matrix((vals, cols, indptr), shape=self.shape)

    @classmethod
    def from_sparse(cls, A, br: int, bc: int) -> "BlockSparseMatrix":
        """From_Sparse (BlockMatrix.h:1810): cut a scipy matrix into blocks."""
        A = A.tocoo()
        n, m = A.shape
        out = cls((n + br - 1) // br, (m + bc - 1) // bc, br, bc)
        acc: Dict[Tuple[int, int], np.ndarray] = {}
        for r, c, v in zip(A.row, A.col, A.data):
            key = (r // br, c // bc)
            blk = acc.setdefault(key, np.zeros((br, bc)))
            blk[r % br, c % bc] += v
        for (i, j), blk in acc.items():
            out.append_block(i, j, blk)
        return out

    def save_matrix_market(self, path: str) -> None:
        """Save_MatrixMarket (BlockMatrix.h)."""
        from scipy import io as sio

        sio.mmwrite(path, self.to_bsr().tocoo())

    def rasterize(self, path: str) -> None:
        """Sparsity plot (CUberBlockMatrix::Rasterize, BlockMatrix.h:292).
        Raises ImportError, before densifying, where matplotlib is absent."""
        from slampp_tpu_torch.viz.plot import _pyplot, rasterize_block_matrix

        _pyplot()
        rasterize_block_matrix(self.to_dense(), path)

    def device_arrays(self, device="cuda"):
        """(values (nnzb, br, bc) float64, rows, cols int64) as tensors on
        ``device``."""
        rows, cols = self.indices()
        return (_device_values(self, device), torch.as_tensor(rows, device=device),
                torch.as_tensor(cols, device=device))


# ------------------------------------------------ device product primitives


def _device_values(m: BlockSparseMatrix, device) -> torch.Tensor:
    return torch.as_tensor(m.values(), dtype=torch.float64, device=device)


def _index(ids: list, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _reduce_by_dest(keys: np.ndarray, prods: torch.Tensor):
    """Sum the pair products that share a destination key: the host sorts
    and plans the segments, the device gathers and sums.  Returns the
    sorted unique keys and their sums as NumPy (n_keys, r, c)."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    ends = np.r_[starts[1:], len(keys)]
    plan = plan_grouped_segments(starts, ends, m=len(keys),
                                 remap=np.r_[order, len(keys)]).to(prods.device)
    return uniq, grouped_segsum_first(prods, plan).cpu().numpy()
