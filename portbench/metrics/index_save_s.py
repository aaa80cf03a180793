"""index_save_s: the `prefilter.index_save` span (`KmerIndex.save` of the
k-mer index into the job's fresh DB directory), mean over the window's
jobs.  Layer search.prefilter; moves job_s."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(spans.job_spans(ctx), "prefilter.index_save")
