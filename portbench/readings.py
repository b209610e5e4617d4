"""The readings that the limits of ``correct`` are set from: the compared
numbers of the program over many seeds, and of the cell's control (the
program with the lower precision its cell file names switched on), each
run as a short benchmark run in one process.

    python3 portbench/readings.py --workload <cell> --seeds 101,102,...
        [--control-seeds 201,...] [--seconds 1] [--solve JSON]

Prints one JSON line per run ({"seed", "control", "checks", ...}) and a
last line with the largest reading of the program and the smallest of the
control for each number.  The benchmark's own runs never run the control.
"""

import argparse
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="lower and upper readings of a cell's checks")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solve", default="{}",
                    help="JSON of solve parameters that replace the cell's (a diagnostic run)")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)

    from portbench import harness

    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed, control in runs:
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                               control=control, overrides={"solve": json.loads(args.solve)})
        vals = res["readings"]
        side = upper if control else lower
        for k, v in vals.items():
            side.setdefault(k, []).append(v)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": control,
                          "checks": vals, "solves": res["attempted"], "reference": res["reference"],
                          "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                          "reference_s": res["window"]["reference_s"],
                          "host_peak_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "lower": {k: max(v) for k, v in lower.items()},
                      "upper": {k: min(v) for k, v in upper.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
