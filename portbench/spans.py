"""The program's own spans in a traced run, a window job at a time, and
the readings that the per-layer metrics take of them.

The program (`spacedust_tpu_torch/utils/trace.py`) records a span at the
end of each stage while torch.profiler records in its process, which is
the traced run's window.  A span is (name, thread id, t0_ns, t1_ns,
attrs, rss_bytes) on the program's monotonic clock.  A job's spans are
those that start between its `createsetdb.read` span and the next job's.
A program without the recorder, and an untraced run, give nothing to
read: every reading is then None.
"""

from __future__ import annotations

import sys
from bisect import bisect_right

from .trace import _union

RECORDER = "spacedust_tpu_torch.utils.trace"


def recorded(ctx):
    """The program's Recorded spans of a traced run, or None."""
    mod = sys.modules.get(RECORDER)
    if ctx.trace is None or mod is None or not ctx.jobs:
        return None
    return mod.snapshot()


def split_jobs(spans: list, n_jobs: int) -> list | None:
    """The spans of the last n_jobs jobs, one list a job in the order they
    ran; None where fewer jobs were recorded."""
    starts = sorted(s[2] for s in spans if s[0] == "createsetdb.read")
    if n_jobs < 1 or len(starts) < n_jobs:
        return None
    starts = starts[-n_jobs:]
    jobs: list = [[] for _ in starts]
    for s in spans:
        i = bisect_right(starts, s[2]) - 1
        if i >= 0:
            jobs[i].append(s)
    return jobs


def job_spans(ctx) -> list | None:
    rec = recorded(ctx)
    return None if rec is None else split_jobs(rec.spans, len(ctx.jobs))


def mean_seconds(jobs: list | None, name: str) -> float | None:
    """Mean over the jobs of the seconds of their spans called `name`,
    summed within a job (0 in a job without one); None where no job has
    one."""
    if not jobs or not any(s[0] == name for job in jobs for s in job):
        return None
    return sum(sum(s[3] - s[2] for s in job if s[0] == name)
               for job in jobs) / len(jobs) / 1e9


def rss_growth_gib(jobs: list | None) -> float | None:
    """Mean over the jobs of the largest resident set at a span's end
    less that at the end of the job's first span, in GiB."""
    if not jobs or not all(jobs):
        return None
    grow = [max(s[5] for s in job) - min(job, key=lambda s: s[2])[5]
            for job in jobs]
    return sum(grow) / len(grow) / 2**30


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _minus(a: list, b: list) -> list:
    """Sorted disjoint a less sorted disjoint b."""
    out = []
    j = 0
    for s, e in a:
        t = s
        while j < len(b) and b[j][1] <= t:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > t:
                out.append([t, b[k][0]])
            t = max(t, b[k][1])
            k += 1
        if t < e:
            out.append([t, e])
    return out


def idle_unattributed_pct(windows, busy, stage_spans) -> float | None:
    """Of the card's idle time inside `windows` (the harness's createsetdb
    and clustersearch spans), the share in % during which none of
    `stage_spans` (the program's main-thread spans other than the
    commands' own, mapped onto the same clock) is open.  All three are
    (start, end) pairs on one clock; `busy` the card's busy intervals."""
    idle = _minus(_union(windows), _union(busy))
    total = sum(e - s for s, e in idle)
    if total <= 0:
        return None
    return 100.0 * (1.0 - _overlap(idle, _union(stage_spans)) / total)
