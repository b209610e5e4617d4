"""FLOP accounting (counterpart of ``slampp_tpu/utils/flops.py``, which
reads XLA's cost analysis; reference sparse_flops instrumentation,
include/sparse_flops/Instrument.h:40): ``torch.utils.flop_counter``'s
``FlopCounterMode`` counts the FLOPs of the matrix products and
convolutions that one call of a function dispatches, on any device,
without touching the code under test."""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch.utils.flop_counter import FlopCounterMode


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn`` once under a FLOP counter: {"flops": total, "by_operator":
    {op: flops}}.  Operators the counter has no formula for (elementwise
    ops, the port's CUDA kernels) count zero."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = {str(k): int(v) for k, v in counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_operator": by_op}


def flops(fn: Callable, *args, **kwargs) -> float:
    """Total floating-point operations of one invocation of ``fn``."""
    return cost_analysis(fn, *args, **kwargs)["flops"]
