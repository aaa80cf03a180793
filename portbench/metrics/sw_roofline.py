"""sw_roofline: the SW kernels' share of their roofline, in %: the least
time the card could take for the job's DP cells (`fwd_cells + rev_cells`
of the engine's metrics, times portbench/roofline.py's operations a
cell, over its peak) over the kernels' time (`fwd_kernel_ms +
rev_kernel_ms`), summed over the window's jobs.  Layer csrc/sw.cu via
ops.sw_cuda; moves job_s.  Nothing to read off the card, or where no
kernel ran."""

from portbench import roofline


def read(ctx):
    sm = ctx.sm_count()
    if sm is None or not ctx.jobs:
        return None
    least = ms = 0.0
    for job in ctx.jobs:
        d = job["detail"].get("align_detail", {})
        if "fwd_cells" not in d:
            return None
        least += roofline.least_seconds(d["fwd_cells"] + d["rev_cells"],
                                        ctx.kind, sm)
        ms += d["fwd_kernel_ms"] + d["rev_kernel_ms"]
    return 100.0 * least / (ms / 1e3) if ms > 0 else None
