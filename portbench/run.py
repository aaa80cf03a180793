"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload seq.regression --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout that holds `BENCHMARK.json`, `portbench/` and
the port (`spacedust_tpu_torch/`).  Prints the numbers compared as its
last lines on standard error, and one JSON object, the result, as the last
line of standard output.  Exits non-zero, and prints no result, where
CUDA is not available or the card count is below the cell's.
"""

import os
import sys
import time

T_IMPORT = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, heads the import path (a module
# here must not shadow one of the standard library's)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]


def main(argv=None) -> int:
    import argparse
    import json
    from pathlib import Path

    import torch

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import bench
    cell = bench.load_cell(Path(ROOT), a.workload)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = bench.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                         t_import=T_IMPORT)
    lines = bench.stderr_lines(out)
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
