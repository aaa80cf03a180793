"""index_s: the k-mer index build of the sequence prefilter
(`timings.index` of clustersearch's detail line), mean over the window's
jobs.  Layer search.prefilter; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["index"])
