"""The least time the card could take for a call of a hand-written kernel,
from its shapes alone (a frozen copy of ``chip_smoke._bound``'s
arithmetic): the larger of its bytes over the memory rate and its
operations over the peak rate, so a share of it can never pass 100% unless
the time leaves out work.  The work of each kernel is counted by
``counts/<count>.py``.  Peaks: NVIDIA's data sheet for the H100 SXM (dense,
without sparsity): 3.35 TB/s of HBM3; 67 TFLOP/s in float32 outside the
tensor cores and in float64 on them.
"""

from __future__ import annotations

import importlib

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
ITEM = {"float32": 4, "float64": 8}


def work(count: str, shapes, dtype: str):
    """(operations, bytes) of one call, by ``counts/<count>.py``."""
    return importlib.import_module(f"portbench.counts.{count}").work(shapes, dtype)


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS[dtype])


def bound_of_call(count: str, shapes, dtype: str) -> float:
    """The least time of one call, from the shapes of its tensor arguments."""
    return bound_s(*work(count, shapes, dtype), dtype)
