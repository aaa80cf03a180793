"""ingest_s: seconds a job spends in `createsetdb` (the harness's span
round the call), mean over the window's jobs.  Layer workflow.createsetdb
/ db; moves job_s."""


def read(ctx):
    return ctx.mean(lambda job: job["ingest_s"])
