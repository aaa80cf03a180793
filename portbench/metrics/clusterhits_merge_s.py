"""clusterhits_merge_s: the `cluster.clusterhits.merge` spans (the native
agglomeration of each genome pair's hits, native/clusterhits_engine.cpp),
summed a job, mean over the window's jobs.  Layer cluster; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx),
                              "cluster.clusterhits.merge")
