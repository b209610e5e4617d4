"""A percentile over every solve of the window, each timed from its start to
its result on the host (``statistics.quantiles``, inclusive), times
``scale``."""

import statistics


def value(setup_s: float, window: dict, percent: int, scale: float = 1.0) -> float:
    xs = window["solve_s"]
    q = statistics.quantiles(xs, n=100, method="inclusive")[percent - 1] if len(xs) > 1 else xs[0]
    return q * scale
