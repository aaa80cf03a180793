"""search_wall_s: the program's own `clustersearch` span (from the end of
argument parsing to the TSV and its sidecar on disk), mean over the
window's jobs: the traced run's total, against which its per-layer split
is read.  Layer workflow.clustersearch; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "clustersearch")
