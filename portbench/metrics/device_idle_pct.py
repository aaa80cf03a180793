"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card, from torch.profiler's device timeline
(portbench/trace.py).  Layer device; moves job_s.  Nothing to read
without a trace that shows device activity."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
