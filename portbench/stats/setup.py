"""Seconds from process start to the first timed solve."""


def value(setup_s: float, window: dict) -> float:
    return setup_s
