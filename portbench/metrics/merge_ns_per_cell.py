"""merge_ns_per_cell: a job's `cluster.clusterhits.merge` nanoseconds over
its `clusterhits_cells` count (the sum of K^2 over the genome pairs
merged: the initial score matrices' cells), mean over the window's jobs.
The engine's cost a score cell, comparable where K changes.  Layer
cluster; moves job_s.

A count (name, tid, t_ns, n) has its time where a span has its start, so
spans.split_jobs splits counts and spans into jobs together."""

from portbench import spans

SPAN = "cluster.clusterhits.merge"
COUNT = "clusterhits_cells"


def read(ctx):
    rec = spans.recorded(ctx)
    if rec is None:
        return None
    jobs = spans.split_jobs(rec.spans + rec.counts, len(ctx.jobs))
    if jobs is None:
        return None
    per_job = []
    for job in jobs:
        cells = sum(c[3] for c in job if c[0] == COUNT)
        if cells > 0:
            per_job.append(sum(s[3] - s[2] for s in job if s[0] == SPAN)
                           / cells)
    return sum(per_job) / len(per_job) if per_job else None
