"""Rank-parallel chunk elimination for the windowed / FastL solvers
(counterpart of ``slampp_tpu/parallel/distributed_incremental.py``).

The windowed and FastL solvers' expensive periodic events are chunk
(re)freezes: eliminating each frozen chunk's interior at its current
linearization and caching its Schur complement onto the separator.  Chunks
are mutually independent, so a relinearization sweep that refreezes many
chunks is an embarrassingly parallel batch: each rank eliminates its
contiguous share of the batch with ONE batched Cholesky and triangular
solve (``torch.linalg``, as the JAX module's ``lax.linalg``), and one
all-gather per output gives every rank the whole batch.  Like the JAX
module it is not wired into the solvers, whose sequential NumPy path stays
the default.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from slampp_tpu_torch.parallel.distributed import Mesh

F64 = torch.float64


def _eliminate(H, g, ni, reg):
    """Batched chunk elimination: H (c, D, D) padded chunk systems
    (interior-first layout, identity on padding), g (c, D), ni (c,)
    interior scalar dims.  Returns (L, WU, y, contrib_sc, contrib_rhs) with
    boundary rows beyond D - ni zero."""
    D = H.shape[-1]
    r = torch.arange(D, device=H.device)
    im = r[None, :] < ni[:, None]  # (c, D) interior mask
    bm = ~im
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    # the interior-interior block of H, identity elsewhere: one batched
    # Cholesky of shape (c, D, D) factors every chunk's interior
    A = torch.where(im[:, :, None] & im[:, None, :], H, eye) + reg * eye
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.transpose(1, 2)))
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    U = torch.where(im[:, :, None] & bm[:, None, :], H, 0.0)
    WU = torch.linalg.solve_triangular(L, U, upper=False)
    y = torch.linalg.solve_triangular(L, torch.where(im, g, 0.0)[..., None], upper=False)[..., 0]
    Hss = torch.where(bm[:, :, None] & bm[:, None, :], H, 0.0)
    contrib_sc = Hss - torch.einsum("cds,cdt->cst", WU, WU)
    contrib_rhs = torch.where(bm, g, 0.0) - torch.einsum("cds,cd->cs", WU, y)
    return L, WU, y, contrib_sc, contrib_rhs


def eliminate_chunks_mesh(Hs: np.ndarray, gs: np.ndarray, ni: np.ndarray, mesh: Mesh,
                          reg: float = 1e-12) -> Tuple[np.ndarray, ...]:
    """Eliminates a batch of frozen chunks over the ranks.

    Hs (C, D, D), gs (C, D), ni (C,): padded chunk systems in
    interior-first layout (identity on padding).  Rank r factors chunks
    [r per, (r + 1) per), per = ceil(C / world), its share padded with
    identity chunks to per.  Returns (L, WU, y, contrib_sc, contrib_rhs) as
    (C, ...) host arrays on every rank: the quantities the windowed / FastL
    freeze records cache."""
    C, D, _ = Hs.shape
    lo, hi, per = mesh.share(C)
    pad = per - (hi - lo)
    H = np.concatenate([Hs[lo:hi], np.broadcast_to(np.eye(D), (pad, D, D))])
    g = np.concatenate([gs[lo:hi], np.zeros((pad, D))])
    n = np.concatenate([np.asarray(ni)[lo:hi], np.full(pad, D)])
    out = _eliminate(torch.as_tensor(H, dtype=F64, device=mesh.device),
                     torch.as_tensor(g, dtype=F64, device=mesh.device),
                     torch.as_tensor(n, dtype=torch.int64, device=mesh.device), reg)
    return tuple(mesh.all_gather(o)[:C].cpu().numpy() for o in out)


def pack_chunks(
    chunks: List[Tuple[np.ndarray, np.ndarray, int]], bucket: int = 32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pads variable-size chunk systems (H, g, ni) to one bucketed D."""
    D = max(h.shape[0] for h, _, _ in chunks)
    D = ((D + bucket - 1) // bucket) * bucket
    C = len(chunks)
    Hs = np.tile(np.eye(D), (C, 1, 1))
    gs = np.zeros((C, D))
    nis = np.zeros(C, np.int32)
    for k, (h, g, ni) in enumerate(chunks):
        d = h.shape[0]
        Hs[k, :d, :d] = h
        gs[k, :d] = g
        nis[k] = ni
    return Hs, gs, nis, D
