"""prefilter_wait_s: the exposed wait for the background prefilter
(`timings.prefilter`), mean over the window's jobs: the time the main
thread waited for the native matcher, not its busy time.  Layer
search.prefilter; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["detail"]["prefilter"])
