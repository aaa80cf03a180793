"""enqueue_s: the `align.enqueue` spans (`_AlignStream.add`: a chunk's
identity and coverage pre-check, its forward jobs, and the forward stages
dispatched when the engine's buffer fills), summed over a job's chunks,
mean over the window's jobs.  Layer search.alignment; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "align.enqueue")
