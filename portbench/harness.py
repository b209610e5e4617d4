"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one cell, configuration, route, reference,
end-to-end metric or per-layer metric sits in a file of its own, found by
the name that ``BENCHMARK.json`` or the cell's file gives it:

* ``workloads/<cell>.json``: its configuration, the solve's parameters,
  warm-up and traced solves, the control and the limits of ``correct``;
* ``configs/<config>.json``: the deployment (generator and sizes), its
  route and its reference;
* ``routes/<route>.py``: the driver of the program's entry point;
* ``reference/<reference>.py``: the plain reference and its ``compare``;
* ``traffic/<generator>.py``: the generator a configuration names;
* ``end_to_end/<metric>.json``: the statistic of the window it reports,
  ``stats/<stat>.py``, and its parameters;
* ``layers/<metric>.json``: the reader of the traced stretch,
  ``readers/<reader>.py``, and its parameters; a roofline's reader counts
  each kernel's work with ``counts/<count>.py``.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import traces

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "slampp_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_files(cell_name: str):
    """(cell, config) as their files hold them."""
    cell = load_json(BENCH / "workloads" / f"{cell_name}.json")
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    return cell, config


def metrics_of(bench: dict, cell_name: str, kind: str):
    """The entries of ``bench[kind]`` this cell reports: those that list it,
    and those with no list whose ``moves`` metric it reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])}
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``slampp_tpu_torch`` is the port)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"nvidia_smi": out or "unavailable"}


def end_to_end_value(name: str, setup_s: float, window: dict) -> float:
    d = load_json(BENCH / "end_to_end" / f"{name}.json")
    stat = importlib.import_module(f"portbench.stats.{d['stat']}")
    return stat.value(setup_s, window, **d.get("params", {}))


def layer_reader(name: str):
    """(the reader module, its parameters) of per-layer metric ``name``."""
    d = load_json(BENCH / "layers" / f"{name}.json")
    return importlib.import_module(f"portbench.readers.{d['reader']}"), d.get("params", {})


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_start=None, control: bool = False, overrides=None) -> dict:
    """One run; returns the result object (``checks`` its last key).
    ``control`` runs the cell's control in the program's place: the solve
    parameters of its ``solve``, TF32 products (``tf32``), or the reference
    one precision below (``reference``).  ``overrides`` ({"generator":
    {...}, "solve": {...}}) resize a cell for tests on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, config = cell_files(cell_name)
    overrides = overrides or {}
    config["generator"]["args"].update(overrides.get("generator", {}))
    cell["solve"].update(overrides.get("solve", {}))
    solve = dict(cell["solve"])
    importlib.import_module("slampp_tpu_torch")  # sets its own TF32 policy
    if control:
        solve.update(cell["control"].get("solve", {}))
        _set_tf32(bool(cell["control"].get("tf32", False)))
    route_mod = importlib.import_module(f"portbench.routes.{config['route']}")
    ref_mod = importlib.import_module(f"portbench.reference.{config['reference']}")

    route = route_mod.Route(config, solve, seed, device)
    for _ in range(int(cell["warmup_solves"])):
        route.solve()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    raws, solve_s, iterations = [], [], []

    def one_solve():
        t0 = time.perf_counter()
        raw, it = route.solve()
        _sync(device)
        solve_s.append(time.perf_counter() - t0)
        raws.append(raw)
        iterations.append(it)

    view = None
    if traced:
        readers = {m["name"]: layer_reader(m["name"])
                   for m in metrics_of(bench, cell_name, "per_layer")}
        targets = sorted({tuple(t) for r, params in readers.values() if hasattr(r, "wraps")
                          for t in r.wraps(**params)})

        def stretch():
            t0 = time.perf_counter()
            while (len(raws) < int(cell["trace_solves"])
                   and time.perf_counter() - t0 < seconds):
                with torch.profiler.record_function("portbench.solve"):
                    one_solve()

        with traces.wrap(targets):
            view = traces.capture(stretch, device)
        window_s = view.window_s
    else:
        t0 = time.perf_counter()
        while True:
            one_solve()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX stack or package are loaded: {', '.join(found)}")

    # the program's state is freed before the reference runs
    outputs = [route.output(raw) for raw in raws]
    inputs = route.inputs()
    route.release()
    del route, raws
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _set_tf32(False)
    t_ref = time.perf_counter()
    ref = ref_mod.run(inputs, cell["solve"], device)
    if control and "reference" in cell["control"]:
        # the reference in the program's place, one precision below
        outputs = [ref_mod.run(inputs, cell["solve"], device, **cell["control"]["reference"])]
    limits = cell.get("limits", {})
    worst, failed = {}, 0
    for out in outputs:
        nums = ref_mod.compare(ref, out)
        bad = not limits
        for k, v in nums.items():
            w = worst.get(k)  # a number that is not finite stays the worst
            if w is None or (math.isfinite(w) and (not math.isfinite(v) or v > w)):
                worst[k] = v
            if k in limits:
                bad |= not math.isfinite(v) or v > limits[k]
        failed += bad
    attempted = len(outputs)
    correct = attempted > 0 and failed == 0
    reference_s = time.perf_counter() - t_ref

    window = {"iterations": iterations, "solve_s": solve_s, "window_s": window_s}
    metrics = {}
    if traced:
        for m in metrics_of(bench, cell_name, "per_layer"):
            reader, params = readers[m["name"]]
            value = reader.read(view, sum(iterations), **params)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": end_to_end_value(m["name"], setup_s, window),
                                  "unit": m["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(cell["chips"]), "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and device.type == "cuda":
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        result["breakdown"] = view.breakdown()
    ms = [1e3 * t for t in solve_s]
    result["window"] = {"solves": attempted, "iterations": sum(iterations),
                        "window_s": window_s, "setup_s": setup_s, "reference_s": reference_s,
                        "solve_ms_min_median_max": [min(ms), statistics.median(ms), max(ms)]}
    if device.type == "cuda":
        result["card"] = _card()
    result["reference"] = ref_mod.summary(ref)
    result["readings"] = worst  # every number compare() gives, compared or not
    result["checks"] = {k: {"value": worst.get(k, math.nan), "limit": lim}
                        for k, lim in limits.items()}
    return result


def check_lines(result: dict):
    """Each compared number beside its limit, one per line."""
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in result["checks"].items()]
