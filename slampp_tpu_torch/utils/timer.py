"""Phase timers with accumulated per-phase breakdowns (counterpart of
``slampp_tpu/utils/timer.py``; reference CTimer / CTimerSampler,
include/slam/Timer.h:269,391).

Device work is asynchronous under PyTorch as under JAX: a phase times its
device work only if it reads a result back (the solvers call ``float()`` on
each step's outputs, which synchronizes).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    def __init__(self):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t
            self.counts[name] += 1

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def dump(self) -> None:
        print("=== timing breakdown ===")
        for name in sorted(self.acc, key=self.acc.get, reverse=True):
            print(f"  {name:<24s} {self.acc[name]:9.4f} s  ({self.counts[name]} calls)")
        print(f"  {'wall total':<24s} {self.total():9.4f} s")
