"""The share (%) of the instances of the spans ``among`` in the traced
stretch that are instances of ``span``: a decision counted where it is made,
such as the LM loop's accepted steps among its tested ones."""


def _count(view, name):
    return sum(1 for evs in view.host.values() for s, _, n in evs
               if n == name and view.t0 <= s < view.t1)


def read(view, iterations, span, among):
    total = sum(_count(view, n) for n in among)
    return 100.0 * _count(view, span) / total if total else None
