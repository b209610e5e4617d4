"""The fine-slot sums of the sparse Schur engine's reduced pose system
(``linear/schur_sparse.py``, under ``ss.pairs``): each hit slot's head
blocks (pose-pose Hii, Hjj, Hij, pose-landmark Hpp) and its pair
corrections -BD[e] B[f]^T, summed into that slot's block.

The JAX package formed every pair correction with an XLA einsum over
gathered rows and summed them with a segment sum
(``slampp_tpu/linear/schur_sparse.py``); no Pallas kernel.  ``slot_sums``
dispatches on the device of its operands, as ``ops/dense_kernels.py``'s
functions do:

* CPU operands take the plain PyTorch version (:func:`slot_sums_plain`):
  the head blocks gathered from their concatenation, every pair correction
  formed as a block, and one grouped segment sum (``ops/segments.py``) over
  the table's slots;
* CUDA operands launch the hand-written kernel (``csrc/schur_kernels.cu``,
  built at first use into the kernels' library by ``ops/_cuda.py``) or
  raise: on a build failure, a refused launch, or operands the kernel does
  not take (other than float64 blocks and rows and an int32 table, on one
  card, contiguous; block dims other than pose 3, 5, 6, 7 and landmark 1, 2,
  3).  There is no fallback from CUDA to the plain version.  The kernel
  reads the table as the engine's plan made it, in range: checking it on
  the card would cost a host read a call.

``launches`` counts the kernel launches; ``reset_launches`` clears it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from slampp_tpu_torch.ops import _cuda
from slampp_tpu_torch.ops.segments import (GroupedSegments, grouped_segsum_first,
                                           plan_grouped_segments)

POSE_DIMS = (3, 5, 6, 7)
LANDMARK_DIMS = (1, 2, 3)

launches = {"slot_sums": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class SlotTable(NamedTuple):
    """The slot-major table of the reduced pose system's Hessian
    contributions, one row of ``hptr`` / ``pptr`` per hit slot in the
    order the kernel walks them (int32 throughout)."""

    out: torch.Tensor  # (n_slots,) the hit slot (row of the result) of each table slot
    hptr: torch.Tensor  # (n_slots + 1,) slot s's head blocks: heads[hptr[s]:hptr[s + 1]]
    heads: torch.Tensor  # (n_heads,) row of [Hii | Hjj | Hij | Hpp]; ~row: transposed
    pptr: torch.Tensor  # (n_slots + 1,) slot s's pairs: pair_e / pair_f[pptr[s]:pptr[s + 1]]
    pair_e: torch.Tensor  # (n_pairs,) row of BD
    pair_f: torch.Tensor  # (n_pairs,) row of B
    grp: Optional[GroupedSegments] = None  # the plain version's segments (CPU plans)

    def to(self, device) -> "SlotTable":
        return SlotTable(*(None if v is None else v.to(device) for v in self))


def plan_slot_segments(hptr: np.ndarray, pptr: np.ndarray) -> GroupedSegments:
    """The plain version's grouped segments over [heads | pairs] blocks:
    segment s is slot s's head blocks, then its pairs, in table order."""
    hptr, pptr = np.asarray(hptr, np.int64), np.asarray(pptr, np.int64)
    n_heads = int(hptr[-1])
    nh = np.diff(hptr)
    starts, ends = hptr[:-1] + pptr[:-1], hptr[1:] + pptr[1:]
    m = int(ends[-1]) if len(ends) else 0
    slot = np.repeat(np.arange(len(nh)), ends - starts)
    o = np.arange(m, dtype=np.int64) - starts[slot]
    remap = np.where(o < nh[slot], hptr[:-1][slot] + o, n_heads + pptr[:-1][slot] + o - nh[slot])
    return plan_grouped_segments(starts, ends, m, remap=np.append(remap, m))


def slot_sums_plain(Hii, Hjj, Hij, Hpp, BD, B, table: SlotTable) -> torch.Tensor:
    """(n_slots, bs, bs): row ``table.out[s]`` the sum of table slot s's
    head blocks (rows of [Hii | Hjj | Hij | Hpp], transposed where coded
    ~row) and pair corrections -BD[e] B[f]^T, each slot summed in one
    grouped segment in table order."""
    code = table.heads.long()
    flip = code < 0
    hb = torch.cat([Hii, Hjj, Hij, Hpp], 0)[torch.where(flip, ~code, code)]
    hb = torch.where(flip[:, None, None], hb.transpose(1, 2), hb)
    pc = -torch.einsum("tik,tjk->tij", BD[table.pair_e.long()], B[table.pair_f.long()])
    grp = table.grp
    if grp is None:
        grp = plan_slot_segments(table.hptr.cpu().numpy(), table.pptr.cpu().numpy()).to(BD.device)
    sums = grouped_segsum_first(torch.cat([hb, pc], 0), grp)
    out = torch.empty_like(sums)
    out[table.out.long()] = sums
    return out


def slot_sums(Hii, Hjj, Hij, Hpp, BD, B, table: SlotTable) -> torch.Tensor:
    """As :func:`slot_sums_plain`, on the card through the kernel; CPU
    operands take the plain version."""
    ops = (Hii, Hjj, Hij, Hpp, BD, B)
    tabs = (table.out, table.hptr, table.heads, table.pptr, table.pair_e, table.pair_f)
    if not any(t.device.type == "cuda" for t in ops + tabs):
        return slot_sums_plain(Hii, Hjj, Hij, Hpp, BD, B, table)
    bs, dl = B.shape[1:] if B.dim() == 3 else (-1, -1)
    if bs not in POSE_DIMS or dl not in LANDMARK_DIMS:
        raise ValueError(f"slot_sums: block dims (pose {bs}, landmark {dl}) not built; "
                         f"pose in {POSE_DIMS}, landmark in {LANDMARK_DIMS}")
    n_pp, n_pl = Hii.shape[0], B.shape[0]
    n_slots, n_pairs = table.out.shape[0], table.pair_e.shape[0]
    f64, i32 = torch.float64, torch.int32
    _cuda.check_operands("slot_sums", [
        (B, (n_pl, bs, dl), f64, 8), (BD, (n_pl, bs, dl), f64, 8),
        (Hpp, (Hpp.shape[0], bs, bs), f64, 8), (Hii, (n_pp, bs, bs), f64, 8),
        (Hjj, (n_pp, bs, bs), f64, 8), (Hij, (n_pp, bs, bs), f64, 8),
        (table.out, (n_slots,), i32, 4), (table.hptr, (n_slots + 1,), i32, 4),
        (table.heads, (table.heads.shape[0],), i32, 4), (table.pptr, (n_slots + 1,), i32, 4),
        (table.pair_e, (n_pairs,), i32, 4), (table.pair_f, (n_pairs,), i32, 4)])
    out = B.new_empty((n_slots, bs, bs))
    lib = _cuda.load()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        _cuda.check(lib, lib.slampp_slot_sums_f64(
            bs, dl, *(t.data_ptr() for t in ops + tabs), n_pp, n_slots, out.data_ptr(), stream),
            "slot_sums")
    launches["slot_sums"] += 1
    return out
