"""Device work enqueued per iteration inside a host span: the runtime and
driver calls that put work on the card's queues (kernel launches, copies,
memsets; a CUDA graph's launch counts once), made on a thread while an
instance of the span ``span`` in the traced stretch was open on it, over
the iterations there.  Synchronisations, queries and event records enqueue
no device work and count zero.  The calls are counted on the host side of
the trace, not from the device ops, of which a trace can lose some."""

import bisect

ENQUEUE = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
           "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
           "cuMemcpy", "cudaMemset", "cuMemset")


def enqueues(name: str) -> bool:
    return name.startswith(ENQUEUE)


def read(view, iterations, span):
    if not view.device or iterations == 0:
        return None
    found, n = False, 0
    for evs in view.host.values():
        starts = [ev[0] for ev in evs]
        for s, e, name in evs:
            if name == span and view.t0 <= s < view.t1:
                found = True
                inside = evs[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
                n += sum(enqueues(x[2]) for x in inside)
    return n / iterations if found else None
