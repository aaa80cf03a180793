"""Entry points to call from outside: one kernel launch to compile and
check, and the multi-shard / multi-process dry run (the port's
counterpart of the JAX package's `__graft_entry__.py`)."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch


def entry(device: torch.device | str = "cuda"):
    """One launch of the forward SW kernel (`ops/sw_cuda.py::sw_forward`,
    the flagship compute path) on a seeded batch of 64 pairs of 200 x 200
    residues, the resident arrays on `device`.  Returns (fn,
    example_args): fn(*example_args) gives the (6, 64) int32 result."""
    from .ops import sw_cuda
    from .stats.submat import load_substitution_matrix

    B, L, n = 64, 256, 200
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    qdata = torch.from_numpy(
        rng.integers(0, 20, B * L).astype(np.uint8)).to(dev)
    qbias = torch.from_numpy(
        rng.integers(-4, 4, B * L).astype(np.int8)).to(dev)
    tdata = torch.from_numpy(
        rng.integers(0, 20, B * L).astype(np.uint8)).to(dev)
    sub = torch.from_numpy(
        load_substitution_matrix().sub_int.astype(np.int8)).to(dev)
    offs = np.arange(B, dtype=np.int64) * L
    jobs = np.stack([offs, np.full(B, n), offs, np.full(B, n),
                     np.zeros(B, np.int64)]).astype(np.int64)
    return sw_cuda.sw_forward, (qdata, qbias, tdata, sub, jobs, 11, 1)


def _toy_genomes(n_sets: int = 2, genes_per_set: int = 24,
                 gene_len: int = 72, seed: int = 7):
    """Two synthetic genomes sharing a conserved, order-preserved gene
    block (so the full pipeline produces real hits and a cluster)."""
    from .db.setdb import DBTYPE_AMINO_ACIDS, SetDB

    rng = np.random.default_rng(seed)
    shared = [rng.integers(0, 20, gene_len).astype(np.uint8)
              for _ in range(6)]
    seq_parts, names, headers, set_ids, sources = [], [], [], [], []
    offsets = [0]
    for s in range(n_sets):
        sources.append(f"toy{s}.faa")
        for g in range(genes_per_set):
            if 4 <= g < 10:           # conserved neighborhood block
                seq = shared[g - 4].copy()
                mut = rng.integers(0, gene_len, 4)
                seq[mut] = rng.integers(0, 20, 4)
            else:
                seq = rng.integers(0, 20, gene_len).astype(np.uint8)
            start = 100 + g * 300
            names.append(f"toy{s}_{g}_{start}_{start + gene_len * 3 - 1}")
            headers.append(names[-1])
            set_ids.append(s)
            seq_parts.append(seq)
            offsets.append(offsets[-1] + len(seq))
    db = SetDB(dbtype=DBTYPE_AMINO_ACIDS,
               seq_data=np.concatenate(seq_parts),
               offsets=np.asarray(offsets, dtype=np.int64),
               names=names, set_ids=np.asarray(set_ids, dtype=np.int32),
               headers=headers, sources=sources)
    db.finalize_metadata()
    return db


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> None:
    """The sharded clustersearch over n_devices target shards
    (make_mesh: the cards round-robin, all on one card where there is
    one) and the 2-process run of parallel/multihost.py (max(1,
    n_devices // 2) shards a process), on the synthetic `small` set;
    both TSVs must equal the single engine's."""
    from . import synth
    from .db.fasta import create_setdb_from_fastas
    from .parallel.multihost import run_multihost
    from .parallel.pipeline import sharded_cluster_search
    from .workflow.clustersearch import ClusterSearchParams, cluster_search

    par = ClusterSearchParams(filter_self_match=True)
    with tempfile.TemporaryDirectory(prefix="dryrun_multichip_") as work:
        db = create_setdb_from_fastas(synth.write_genome_set(work, "small"))
        single = cluster_search(db, db, par, device=device)
        sharded = sharded_cluster_search(db, db, par, n_shards=n_devices,
                                         device=device)
        if sharded.tsv != single.tsv:
            raise RuntimeError("sharded TSV != single TSV")
        n_hits = sum(1 for ln in sharded.tsv.splitlines()
                     if ln.startswith(">"))
        print(f"dryrun_multichip({n_devices}): sharded clustersearch == "
              f"single ({len(sharded.clusters)} clusters, {n_hits} hits)")

        local = max(1, n_devices // 2)
        db.save(f"{work}/db")
        out = run_multihost(f"{work}/db", f"{work}/result.tsv", 2, par,
                            tmp_dir=f"{work}/tmp", local_devices=local,
                            device=str(device))
        if Path(out).read_text() != single.tsv:
            raise RuntimeError("multihost TSV != single-process TSV")
        print(f"dryrun_multichip({n_devices}): 2-process x {local}-shard "
              "multihost TSV == single-process")
