"""AlignmentEngine.align_all of the port (SW on the CPU, plain version)
against the JAX package on the same candidate dict: the AlnRecord lists
must be equal field for field, CIGAR and raw score included."""

import dataclasses

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.search.alignment import AlignmentEngine as JaxEngine
from spacedust_tpu.search.alignment import AlignmentParams as JaxParams
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.search.alignment import (AlignmentEngine,
                                                  AlignmentParams)
from spacedust_tpu_torch.search.prefilter import PrefilterEngine

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dbs_and_candidates(tmp_path_factory):
    fastas = synth.write_genome_set(tmp_path_factory.mktemp("small"),
                                    "small")
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    hits = PrefilterEngine(db, db).match_range(0, db.size)
    # genes up to 700 aa keep the plain CPU scan quick
    short = np.nonzero(db.lengths <= 700)[0]
    rng = np.random.default_rng(5)
    cands = {}
    for qk in short[::3].tolist():
        extra = rng.choice(short, 3).tolist()          # mostly rejected
        cands[qk] = [h.seq_id for h in hits[qk]
                     if db.lengths[h.seq_id] <= 700] + extra
    return db, jdb, cands


# (eval_thr, cov_thr, cov_mode, aln_len_thr): the engine default and the
# clustersearch workflow's settings
@pytest.mark.parametrize("par", [(1e-3, 0.0, 0, 0), (10.0, 0.8, 2, 30)])
def test_align_all_matches_jax(dbs_and_candidates, par):
    db, jdb, cands = dbs_and_candidates
    kw = dict(eval_thr=par[0], cov_thr=par[1], cov_mode=par[2],
              aln_len_thr=par[3])
    got = AlignmentEngine(db, db, AlignmentParams(**kw),
                          device="cpu").align_all(cands)
    ref = JaxEngine(jdb, jdb, JaxParams(**kw)).align_all(cands)
    assert list(got) == list(ref)
    n = 0
    for qk in ref:
        g = [dataclasses.astuple(r) for r in got[qk]]
        r = [dataclasses.astuple(r) for r in ref[qk]]
        assert g == r, qk
        n += sum(1 for rec in ref[qk] if rec.tkey != qk)
    assert n >= 20                   # non-identity alignments were checked
