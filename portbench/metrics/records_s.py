"""records_s: the `align.records` spans (bit scores, checkCriteria and
AlnRecord after the traceback; the accept stage and the sort), mean over
the window's jobs.  Layer search.alignment; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "align.records")
