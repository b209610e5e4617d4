"""Device idle milliseconds per iteration, split by what the host was in:
inside each instance of the request span ``solve`` (on the thread that
opened it), the time during which layer span L of ``layers`` is the
outermost of them open belongs to L, and the time with none of them open to
``glue``; the rest of the traced stretch is ``outside``.  In each part the
idle time is where no device op (kernel, copy, memset) ran.  The parts
split the stretch, so their idle times sum to the stretch's idle time
(``idle``).  ``part`` names the part read."""

import bisect


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Busy:
    """Device busy time within [a, b] (trace microseconds)."""

    def __init__(self, view):
        clipped = ((max(s, view.t0), min(e, view.t1)) for s, e, _, _ in view.device)
        self.runs = _merge((s, e) for s, e in clipped if e > s)
        self.starts = [s for s, _ in self.runs]

    def idle(self, a: float, b: float) -> float:
        busy = 0.0
        k = max(0, bisect.bisect_right(self.starts, a) - 1)
        while k < len(self.runs) and self.runs[k][0] < b:
            busy += max(0.0, min(b, self.runs[k][1]) - max(a, self.runs[k][0]))
            k += 1
        return (b - a) - busy


def split(view, solve, layers):
    """{each layer, "glue", "outside": idle seconds} over the traced
    stretch, or None where no ``solve`` span opened in it."""
    busy = _Busy(view)
    idle = dict.fromkeys([*layers, "glue"], 0.0)
    solves = []
    for evs in view.host.values():
        mine = [(s, e) for s, e, name in evs if name == solve and view.t0 <= s < view.t1]
        solves += mine
        spans = [(s, e, name) for s, e, name in evs if name in idle]
        for S, E in mine:
            E = min(E, view.t1)
            idle["glue"] += busy.idle(S, E)
            end = S
            for s, e, name in spans:  # in start order: a span inside the last counted is nested
                if s < S or s >= E or s < end:
                    continue
                end = min(e, E)
                part = busy.idle(s, end)
                idle[name] += part
                idle["glue"] -= part
    if not solves:
        return None
    idle["outside"] = busy.idle(view.t0, view.t1) - sum(
        busy.idle(s, min(e, view.t1)) for s, e in _merge(solves))
    return {k: v * 1e-6 for k, v in idle.items()}


def read(view, iterations, solve, layers, part):
    if not view.device or iterations == 0:
        return None
    parts = split(view, solve, layers)
    return None if parts is None else 1e3 * parts[part] / iterations
