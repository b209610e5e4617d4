"""How far the sparse marginals' gap to the dense ones comes from the v2
engine's prefix-sum segment reductions.

``core/sparse_chol2._segsum`` (and its import in
``marginals/sparse_marginals.py``) forms each segment sum as the difference
of two entries of one running prefix sum, which cancels when the prefix is
large against the segment.  This script runs
``apps.manhattan.run_marginals(n, "cpu")`` four times in one process: as
shipped, then with an exact segment sum (each segment summed on its own,
in order) in place of the prefix-sum difference in the Takahashi
recursion, in the factorization and solves (which also moves the GN
linearization point, so the dense result too), and in both.  It prints one
JSON line per run: the largest relative block difference of the sparse
marginals against the dense ones, and each side's sum of block traces.

    python scripts/marginals_segsum_ab.py [n_poses]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from slampp_tpu_torch.apps import manhattan  # noqa: E402
from slampp_tpu_torch.core import sparse_chol2  # noqa: E402
from slampp_tpu_torch.marginals import sparse_marginals  # noqa: E402


def exact_segsum(terms: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Segment sums of ``terms``, each segment accumulated on its own."""
    out = terms.new_zeros((starts.shape[0],) + terms.shape[1:])
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        acc = None
        for k in range(s, e):
            acc = terms[k] if acc is None else acc + terms[k]
        if acc is not None:
            out[i] = acc
    return out


def main(n_poses: int) -> None:
    shipped = sparse_chol2._segsum
    for mode, takahashi, factor in (("prefix", False, False), ("exact-takahashi", True, False),
                                    ("exact-factor", False, True), ("exact-both", True, True)):
        sparse_marginals._segsum = exact_segsum if takahashi else shipped
        sparse_chol2._segsum = exact_segsum if factor else shipped
        res = manhattan.run_marginals(n_poses, "cpu")
        print(json.dumps({"mode": mode, "n_poses": n_poses,
                          **{k: res[k] for k in ("max_rel_block_diff", "trace_sum",
                                                 "trace_sum_sparse")}}), flush=True)
    sparse_marginals._segsum = sparse_chol2._segsum = shipped


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3500)
