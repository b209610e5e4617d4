"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the port (``slampp_tpu_torch``), on a machine with as many CUDA
cards as the cell asks for.  The last line of standard output is the
result as one JSON object; the last lines of standard error give each
number that decided ``correct`` beside its limit.  Without the cards, or
where the port cannot be loaded, it prints no result and exits non-zero.
The build and kernel caches go to fixed directories under
``.portbench_cache/`` in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder
    if not (ROOT / "slampp_tpu_torch" / "__init__.py").is_file():
        print(f"the port (slampp_tpu_torch) is not in {ROOT}", file=sys.stderr)
        return 3

    import torch

    from portbench import harness

    cell, _ = harness.cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    print(json.dumps(result))
    sys.stdout.flush()
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
