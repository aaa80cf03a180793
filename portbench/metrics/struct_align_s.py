"""struct_align_s: the structure search's `align_all` (SW passes, the
per-pair traceback, records; `align_detail.align_all_s`), mean over the
window's jobs.  Layer search.structure; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["align_detail"]["align_all_s"])
