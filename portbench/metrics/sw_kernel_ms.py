"""sw_kernel_ms: milliseconds of the SW kernels a job runs, forward and
reverse stages (`align_detail.fwd_kernel_ms + rev_kernel_ms`: the
program's CUDA events round its launches, fork to join on a split
stage), mean over the window's jobs.  Layer csrc/sw.cu via ops.sw_cuda;
moves job_s.  Nothing to read off the card."""


def read(ctx):
    if ctx.device != "cuda":
        return None
    return ctx.mean(lambda job: job["detail"]["align_detail"]["fwd_kernel_ms"]
                    + job["detail"]["align_detail"]["rev_kernel_ms"])
