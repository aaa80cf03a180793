"""align_s: the streamed alignment (`timings.align`: enqueue, the SW
kernels, the traceback, records), mean over the window's jobs.  Layer
search.alignment; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["align"])
