"""Generators of the benchmark's inputs, found by name: the module
``portbench/traffic/<name>.py`` exposes ``generate(seed, **args)``, and a
configuration's ``generator`` entry names it and gives its ``args``.  The
same seed gives the same inputs."""

from __future__ import annotations

import importlib


def generate(spec: dict, seed: int):
    """What generator ``spec["name"]`` makes from ``seed`` with ``spec["args"]``."""
    mod = importlib.import_module(f"portbench.traffic.{spec['name']}")
    return mod.generate(seed=seed, **spec["args"])
