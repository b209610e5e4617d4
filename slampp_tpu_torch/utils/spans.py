"""Profiler spans behind one gate.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler runs, and one shared null context otherwise: with no profiler a
span costs a flag read, not the construction and entry of a range.  The
spans are the profiler's own ranges, so a trace puts them on one clock
with the device ops they launch; a span's parent is the span open around
it on the same thread.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` on the trace when a profiler runs."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
