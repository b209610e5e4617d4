"""Device traces of a stretch of solves, and what the per-layer readers
read from them.

``capture(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activities) inside a ``portbench.window`` range, writes the Chrome trace to
a temporary file under TMPDIR, reads it back and deletes it.  A device op is
a kernel, a copy or a memset; the device is busy in the union of their
intervals, so that streams that overlap never count twice.  A device op
belongs to every host range (``record_function``) that was open on the
launching thread when it was launched, found through the launch's
correlation id.  ``wrap`` marks each call of a program function with a
range named after its tensor arguments' shapes and dtype, so that a reader
can count the call's work from shapes alone.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "portbench.window"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


def _label(args) -> str:
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    shapes = ";".join("x".join(str(d) for d in t.shape) for t in tensors)
    dtype = str(tensors[0].dtype).replace("torch.", "") if tensors else "none"
    return f"{shapes}:{dtype}"


@contextlib.contextmanager
def wrap(targets):
    """Within the block, each (module, function) of ``targets`` is replaced
    by a wrapper that opens ``portbench.call:<function>:<shapes>:<dtype>``
    around the original call."""
    saved = []
    try:
        for mod_name, fn_name in targets:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)

            def wrapper(*args, _orig=orig, _name=fn_name, **kw):
                with record_function(f"{CALL}:{_name}:{_label(args)}"):
                    return _orig(*args, **kw)

            saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, wrapper)
        yield
    finally:
        for mod, fn_name, orig in reversed(saved):
            setattr(mod, fn_name, orig)


def capture(fn, device) -> "TraceView":
    """Run ``fn()`` traced and read its trace."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return TraceView(events)


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class TraceView:
    """Times in seconds; the trace's own are microseconds."""

    def __init__(self, events):
        device, launches, host = [], {}, defaultdict(list)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                device.append((ts, ts + dur, ev.get("name", ""), args.get("correlation")))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, ev.get("tid"))
                host[ev.get("tid")].append((ts, ts + dur, ev.get("name", "")))
            elif cat in HOST_CATS:
                host[ev.get("tid")].append((ts, ts + dur, ev.get("name", "")))
        wins = [(s, e, tid) for tid, evs in host.items() for s, e, n in evs if n == WINDOW]
        if not wins:
            raise RuntimeError("the trace holds no portbench.window range")
        self.t0, self.t1, self.tid = wins[0]
        self.window_s = (self.t1 - self.t0) * 1e-6
        device.sort()
        self.device = [d for d in device if d[1] > self.t0 and d[0] < self.t1]
        clipped = ((max(s, self.t0), min(e, self.t1)) for s, e, _, _ in self.device)
        self.busy_s = _union(clipped) * 1e-6
        # device ops by the launching thread, in launch order
        self._by_launch = defaultdict(list)
        for s, e, name, corr in self.device:
            if corr in launches:
                lts, tid = launches[corr]
                self._by_launch[tid].append((lts, s, e))
        for lst in self._by_launch.values():
            lst.sort()
        self._launch_ts = {tid: [x[0] for x in lst] for tid, lst in self._by_launch.items()}
        self.host = {tid: sorted(evs) for tid, evs in host.items()}

    def idle_pct(self):
        """The share of the window (%) in which no device op ran, or None
        where no device op ran at all."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def _ops_in(self, s: float, e: float, tid):
        ts = self._launch_ts.get(tid, [])
        lst = self._by_launch.get(tid, [])
        return [(a, b) for _, a, b in lst[bisect.bisect_left(ts, s):bisect.bisect_right(ts, e)]]

    def ranges(self, match):
        """[(name, device seconds)] of each instance of a host range whose
        name satisfies ``match``, on any thread, in time order."""
        out = []
        for tid, evs in self.host.items():
            for s, e, name in evs:
                if match(name):
                    out.append((s, name, _union(self._ops_in(s, e, tid)) * 1e-6))
        return [(name, sec) for _, name, sec in sorted(out)]

    def range_device_s(self, name: str):
        """Summed device time of every instance of range ``name``, or None
        where the range never opened."""
        found = self.ranges(lambda n: n == name)
        return sum(sec for _, sec in found) if found and self.device else None

    def calls(self, fn_name: str):
        """[(shapes, dtype, device seconds)] of each ``wrap``ped call of
        ``fn_name``."""
        out = []
        if not self.device:
            return out
        prefix = f"{CALL}:{fn_name}:"
        for name, sec in self.ranges(lambda n: n.startswith(prefix)):
            shapes, dtype = name[len(prefix):].rsplit(":", 1)
            dims = tuple(tuple(int(d) for d in s.split("x")) for s in shapes.split(";"))
            out.append((dims, dtype, sec))
        return out

    def _host_at(self, t: float) -> str:
        """The innermost host op open on the window's thread at time t."""
        evs = self.host.get(self.tid, [])
        k = bisect.bisect_right(evs, (t, float("inf"), "")) - 1
        for s, e, name in reversed(evs[max(0, k - 5000):k + 1]):
            if e >= t and name != WINDOW:
                return name
        return "host, outside any traced op"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle gaps summed by
        what the host was doing in their middle, each [name, seconds]."""
        by_op = defaultdict(float)
        for s, e, name, _ in self.device:
            by_op[name[:160]] += (min(e, self.t1) - max(s, self.t0)) * 1e-6
        gaps, end = [], self.t0
        for s, e, _, _ in self.device:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        by_host = defaultdict(float)
        for s, e in gaps:
            # a gap shorter than a launch is the launch path itself
            name = self._host_at(0.5 * (s + e))[:160] if e - s >= 20.0 else "gaps under 20 us"
            by_host[name] += (e - s) * 1e-6
        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
