"""struct_prefilter_s: the structure search's 3Di k-mer index and
`match_all` (`align_detail.index_s + prefilter_s`), mean over the
window's jobs.  Layer search.structure; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["align_detail"]["index_s"]
                    + job["detail"]["align_detail"]["prefilter_s"])
