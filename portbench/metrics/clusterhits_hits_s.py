"""clusterhits_hits_s: the `cluster.clusterhits.hits` spans (building each
genome pair's hit list from its match lines), summed a job, mean over the
window's jobs.  Layer cluster; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "cluster.clusterhits.hits")
