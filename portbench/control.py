"""Readings that set the limits of the comparison, on the card at a cell's
own size; the benchmark's runs never run this.

    python3 portbench/control.py --workload seq.regression \
        --seeds 11,12,13 [--fault half]

For each seed: the cell's inputs, one job through the program as a
window runs it, then the comparison of reference/judge.py against the
program's outputs and its verdict under the cell's limits (the sound
reading, `program` and `correct`), and the same comparison and verdict
with the reference computed in int8 put in the program's place for the
SW answers (the control's reading, `control` and `control_correct`).
With --fault, the job runs with that fault of faults.py planted in the
program, and the control is not read.  Prints one JSON line a seed.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]


def readings(cell, seed: int, device: str, fault: str | None,
             scratch) -> dict:
    import contextlib
    import time
    from pathlib import Path

    from portbench import bench, faults
    from portbench.reference.judge import JobOutputs, judge, verdict
    from spacedust_tpu_torch import cli

    scratch = Path(scratch)
    paths, inputs = bench.make_inputs(cell, cell.config["genes"], seed,
                                      scratch / f"in{seed}")
    job_dir = scratch / f"job{seed}"
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        try:
            bench.run_job(cli.main, job_dir, paths, cell, device)
            error = ""
        except Exception as e:        # a crashed job fails the comparison
            error = repr(e)[-500:]
    job_s = time.perf_counter() - t0
    out = JobOutputs.read(job_dir / "out.tsv", job_dir / "tmp")
    digests = [bench.digest_files(job_dir)]
    p, limits = cell.spec["judge"], cell.spec["limits"]
    t1 = time.perf_counter()
    nums = judge(out, digests, inputs, p, seed, device)
    res = {"seed": seed, "fault": fault, "job_s": job_s, "error": error,
           "judge_s": time.perf_counter() - t1, "program": nums,
           "correct": verdict(nums, limits)[0] and not error}
    if fault is None:
        ctl = judge(out, digests, inputs, p, seed, device, control=True)
        res.update(control=ctl, control_correct=verdict(ctl, limits)[0])
    return res


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    a = ap.parse_args(argv)

    from portbench import bench
    cell = bench.load_cell(Path(ROOT), a.workload)
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 3
    bench.CACHE.mkdir(exist_ok=True)
    os.environ["SPACEDUST_CACHE_DIR"] = str(bench.CACHE)
    for seed in (int(s) for s in a.seeds.split(",")):
        scratch = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            print(json.dumps(readings(cell, seed, "cuda", a.fault, scratch)),
                  flush=True)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
