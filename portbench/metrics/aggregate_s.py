"""aggregate_s: the tail (`timings.aggregate`: best hits, merge, combine,
clusterhits, summary, the TSV), mean over the window's jobs.  Layer
cluster; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["aggregate"])
