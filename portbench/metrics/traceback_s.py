"""traceback_s: the `align.traceback` spans (the batched native traceback
of the sequence search, or the structure search's one call a pair), mean
over the window's jobs.  Layer search.alignment; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "align.traceback")
