"""Readers of the traced stretch, found by name: ``readers/<reader>.py``
exposes ``read(view, iterations, **params)``, which returns a number or
None where it finds nothing to read, and may expose
``wraps(**params)``, the (module, function) pairs of the program that the
traced run wraps in ``portbench.call`` ranges (``traces.wrap``).  A
per-layer metric's file ``layers/<metric>.json`` names its ``reader`` and
gives the ``params``.  ``view`` is a ``traces.TraceView``; ``iterations``
counts the solver iterations in the stretch."""
