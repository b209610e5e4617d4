"""Every iteration completed in the window over the window's seconds."""


def value(setup_s: float, window: dict) -> float:
    return sum(window["iterations"]) / window["window_s"]
