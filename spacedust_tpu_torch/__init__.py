"""spacedust_tpu_torch — conserved gene-cluster discovery on PyTorch and
CUDA (NVIDIA Hopper).

The port of the JAX package `spacedust_tpu`, held against it output for
output.  Module names mirror that package:

  db/        columnar SetDB storage + protein FASTA ingestion
  stats/     substitution matrices, Gumbel E-values, P-value chain (f64, host)
  native/    C++/OpenMP host engines: k-mer index + prefilter, tantan,
             composition bias, banded traceback, clusterhits
  ops/       SW score passes: hand-written CUDA kernels (csrc/sw.cu,
             ops/sw_cuda.py), their plain PyTorch versions (ops/sw.py) and
             the device-resident engine (ops/sw_engine.py)
  search/    prefilter + alignment orchestration
  cluster/   besthit / combinehits / clusterhits / summarize
  workflow/  createsetdb / clustersearch pipelines with checkpoint-resume
  synth.py   seeded synthetic genome sets (Prodigal-header protein FASTA)
"""

__version__ = "0.1.0"
