"""prefilter_busy_s: the native matcher's busy time, the `prefilter.match`
spans of the background thread summed over a job's query chunks, mean
over the window's jobs (against prefilter_wait_s, the main thread's
exposed wait).  Layer search.prefilter; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "prefilter.match")
