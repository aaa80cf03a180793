"""The iterative profile search of the port (search --num-iterations;
SW on the CPU, plain version) against the JAX package on the same
inputs, piece by piece and whole: the profile-query prefilter, the
SCORE_ONLY acceptance pass, the profile identity record, the realignment
with the bias matrix, the profile build, the subtraction, the whole
search, and the profile-profile traceback binding (the CLI:
test_torch_iterative_cli.py).  Records must be equal, not
close, in content and in order (tolerance 0: integer SW and the same
float64 E-value code).  Inputs are seeded: `synth.py`'s family set
(chains of divergence, so that the profile rounds find records), its
first genome alone as the tiny set, and planted profiles."""

import dataclasses

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.search import iterative as jax_it
from spacedust_tpu.search.alignment import AlignmentEngine as JaxEngine
from spacedust_tpu.search.alignment import AlignmentParams as JaxParams
from spacedust_tpu.search.prefilter import PrefilterEngine as JaxPrefilter
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.native import banded_align_profile_profile
from spacedust_tpu_torch.search import iterative
from spacedust_tpu_torch.search.alignment import (AlignmentEngine,
                                                  AlignmentParams)
from spacedust_tpu_torch.search.prefilter import PrefilterEngine
from spacedust_tpu_torch.stats.submat import (load_pinned_matrix,
                                              load_substitution_matrix)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def tuples(recs):
    return [dataclasses.astuple(r) for r in recs]


def assert_equal(got, ref):
    """Same queries in the same order, each with the same records in the
    same order, every field and every printed column."""
    assert list(got) == list(ref)
    for qk in ref:
        assert tuples(got[qk]) == tuples(ref[qk]), qk
        assert ([r.columns() for r in got[qk]]
                == [r.columns() for r in ref[qk]]), qk


def n_records(res) -> int:
    return sum(len(v) for v in res.values())


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """The family set in both packages, with the port's prefilter
    candidates (a same-DB search)."""
    fastas = synth.write_genome_set(tmp_path_factory.mktemp("fam"),
                                    "families")
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    cands = {qk: [h.seq_id for h in hs]
             for qk, hs in PrefilterEngine(db, db).match_all().items()}
    return db, jdb, cands, fastas


def random_pssms(db, keys, seed: int):
    """Plausible 8-bit-scaled PSSMs: VTML80 seed-matrix rows and noise."""
    rng = np.random.default_rng(seed)
    m = load_pinned_matrix("vtml80_bf8_bias")
    out = {}
    for qk in keys:
        pssm = m.sub_int[db.sequence(qk)][:, :20].astype(np.int16)
        out[qk] = pssm + rng.integers(-6, 7, pssm.shape).astype(np.int16)
    return out


def aln_profiles(pssms):
    """The (L, 21) int8 alignment profiles of PSSMs (pssm / 4, X column
    0), as build_profiles makes them."""
    out = {}
    for qk, pssm in pssms.items():
        ap = np.zeros((pssm.shape[0], 21), np.int8)
        ap[:, :20] = np.trunc(pssm.astype(np.float64) / 4).astype(np.int8)
        out[qk] = ap
    return out


# ------------------------------------------------------------- prefilter
@pytest.mark.parametrize("same_qt_db", [True, False])
def test_profile_prefilter_matches_jax(fam, same_qt_db):
    """Profile queries through the port's native batch matcher against
    the JAX package's per-query host path (match_query) and its native
    match_all, hit for hit; the index is built at threshold 0."""
    db, jdb, _cands, _ = fam
    keys = list(range(0, db.size, 9))
    pssms = random_pssms(db, keys, 3)
    kw = dict(sensitivity=5.7, max_seqs=50, same_qt_db=same_qt_db,
              query_profiles=pssms, cov_thr=0.8, cov_mode=0)
    eng = PrefilterEngine(db, db, **kw)
    jeng = JaxPrefilter(jdb, jdb, **kw)
    assert eng.index.kmer_thr == jeng.index.kmer_thr == 0
    assert eng.kmer_thr == jeng.kmer_thr
    assert np.array_equal(eng.index.seq_ids, jeng.index.seq_ids)
    got = eng.match_all(keys)
    batch = jeng.match_all(keys)
    n_hits = 0
    for qk in keys:
        want = [(h.seq_id, h.score, h.diagonal) for h in jeng.match_query(qk)]
        assert [(h.seq_id, h.score, h.diagonal) for h in got[qk]] == want, qk
        assert [(h.seq_id, h.score, h.diagonal) for h in batch[qk]] == want
        n_hits += len(want)
    assert n_hits > 3 * len(keys)       # the comparison had material


def test_mixed_query_keys_keep_both_paths(fam):
    """match_all over sequence and profile keys together: the profile keys
    through the profile matcher, the rest as a sequence search."""
    db, jdb, _cands, _ = fam
    pssms = random_pssms(db, [3, 4, 10], 5)
    keys = [1, 2, 3, 4, 5, 10, 11]
    got = PrefilterEngine(db, db, query_profiles=pssms).match_all(keys)
    want = JaxPrefilter(jdb, jdb, query_profiles=pssms).match_all(keys)
    assert sorted(got) == sorted(want) == sorted(keys)
    for qk in keys:
        assert ([(h.seq_id, h.score, h.diagonal) for h in got[qk]]
                == [(h.seq_id, h.score, h.diagonal) for h in want[qk]])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The family set's first genome alone (90 genes) in both packages,
    with the port's prefilter candidates (a same-DB search)."""
    d = tmp_path_factory.mktemp("tiny")
    fastas = synth.write_genome_set(d, "families")[:1]
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    cands = {qk: [h.seq_id for h in hs]
             for qk, hs in PrefilterEngine(db, db).match_all().items()}
    return db, jdb, cands, fastas


# ---------------------------------------------------------- forward pass
ACCEPT = [(1e-3, 0, 0.0, 0), (1e-3, 30, 0.8, 2), (10.0, 100, 0.5, 0),
          (1e-10, 0, 0.0, 1)]


@pytest.mark.parametrize("eval_thr,aln_len,cov,cov_mode", ACCEPT)
def test_forward_accepts_matches_jax(tiny, eval_thr, aln_len, cov,
                                     cov_mode):
    db, jdb, cands, _ = tiny
    args = (cands, eval_thr, aln_len, cov, cov_mode)
    got = AlignmentEngine(db, db, AlignmentParams(),
                          device="cpu").forward_accepts(*args)
    ref = JaxEngine(jdb, jdb, JaxParams()).forward_accepts(*args)
    assert_equal(got, ref)
    recs = [r for v in got.values() for r in v]
    assert len(recs) > len(got)               # more than the self hits
    assert all(r.qstart == -1 for r in recs if r.backtrace == "")


@pytest.mark.parametrize("same_qt_db", [True, False])
def test_forward_accepts_profile_engine(tiny, same_qt_db):
    """The acceptance pass of a profile engine: its length comes from the
    profile, its identity record (same DB) from the profile rows."""
    db, jdb, cands, _ = tiny
    keys = list(range(0, db.size, 3))
    profs = aln_profiles(random_pssms(db, keys, 7))
    sub = {qk: cands[qk] for qk in keys}
    args = (sub, 1e-3, 0, 0.0, 0)
    got = AlignmentEngine(db, db, AlignmentParams(), same_qt_db=same_qt_db,
                          query_profiles=profs,
                          device="cpu").forward_accepts(*args)
    ref = JaxEngine(jdb, jdb, JaxParams(), same_qt_db=same_qt_db,
                    query_profiles=profs).forward_accepts(*args)
    assert_equal(got, ref)
    assert n_records(got) > len(keys) + 10


def test_profile_identity_record(tmp_path):
    """scoreIdentical over a profile: the int16 sum of profile[i, seq[i]],
    including a query whose sum wraps past 32,767."""
    rng = np.random.default_rng(4)
    genes = [rng.integers(0, 20, n).astype(np.uint8) for n in (80, 400, 150)]
    path = tmp_path / "ident.faa"
    synth.write_fasta(path, "IDENT_000001.1", [(g, 1) for g in genes])
    db, jdb = create_setdb_from_fastas([path]), jax_fastas([path])
    profs = {}
    for qk, g in enumerate(genes):
        p = rng.integers(-20, 21, (len(g), 21)).astype(np.int8)
        p[:, 20] = 0
        profs[qk] = p
    profs[1][np.arange(400), genes[1]] = 100        # 40,000: wraps
    eng = AlignmentEngine(db, db, query_profiles=profs, device="cpu")
    jeng = JaxEngine(jdb, jdb, query_profiles=profs)
    got = eng._identity_records_batch(np.arange(3))
    for qk in range(3):
        assert dataclasses.astuple(got[qk]) == dataclasses.astuple(
            jeng._identity_record(qk)), qk
    assert got[1].raw_score == 40000 - 65536


# ----------------------------------------------------------- the rounds
REALIGN = dict(eval_thr=1e-3, cov_thr=0.0, cov_mode=0, aln_len_thr=0)


@pytest.fixture(scope="module")
def realigned(tiny):
    """Round 0 of the JAX package on the tiny set: its realigned
    records."""
    db, jdb, cands, _ = tiny
    return jax_it.align_with_realign(jdb, jdb, cands, JaxParams(**REALIGN),
                                     True)


def test_align_with_realign_matches_jax(tiny, realigned):
    db, _jdb, cands, _ = tiny
    m: dict = {}
    got = iterative.align_with_realign(db, db, cands,
                                       AlignmentParams(**REALIGN), True,
                                       device="cpu", metrics=m)
    assert_equal(got, realigned)
    assert n_records(got) > len(got) + 40
    # the realignment ran over every accepted non-self hit, with the bias
    # matrix, and kept the forward pass's score and E-value
    acc = AlignmentEngine(db, db, AlignmentParams(**REALIGN),
                          device="cpu").forward_accepts(
        cands, 1e-3, 0, 0.0, 0)
    assert m["realign_detail"]["fwd_pairs"] == sum(
        1 for qk, v in acc.items() for r in v if r.tkey != qk)
    fwd = {(qk, r.tkey): (r.score, r.evalue) for qk, v in acc.items()
           for r in v}
    assert all(fwd[qk, r.tkey] == (r.score, r.evalue)
               for qk, v in got.items() for r in v)


def test_realign_engine_scores_with_the_bias_matrix(fam):
    """The engine scores and traces with the matrix it is given: its
    resident table and its composition bias are the bias matrix's."""
    db, _jdb, _cands, _ = fam
    bias_m = load_pinned_matrix("blosum62_bf2_bias")
    assert not np.array_equal(bias_m.sub_int,
                              load_substitution_matrix().sub_int)
    eng = AlignmentEngine(db, db, matrix=bias_m, device="cpu")
    dev = eng._device_db()
    assert np.array_equal(dev.sub.numpy(), bias_m.sub_int.astype(np.int8))
    plain = AlignmentEngine(db, db, device="cpu")
    assert not np.array_equal(eng._qbias_all(), plain._qbias_all())


def test_build_profiles_and_subtract_match_jax(tiny, realigned):
    db, jdb, cands, _ = tiny
    recs = realigned
    pssms, profs = iterative.build_profiles(db, db, recs, 0.1)
    jpssms, jprofs = jax_it.build_profiles(jdb, jdb, recs, 0.1)
    for got, want, dt in ((pssms, jpssms, np.int16),
                          (profs, jprofs, np.int8)):
        assert list(got) == list(want)
        for qk in want:
            assert got[qk].dtype == want[qk].dtype == dt
            assert np.array_equal(got[qk], want[qk]), qk
    # some queries got a profile from more than the query alone
    n_hits = sum(1 for qk, v in recs.items() for r in v
                 if r.tkey != qk and r.evalue < 0.1)
    assert n_hits > 50
    for thr in (1e-30, 1e-3, 0.1):
        assert (iterative.subtract_candidates(cands, recs, thr)
                == jax_it.subtract_candidates(cands, recs, thr))
    assert sum(map(len, iterative.subtract_candidates(
        cands, recs, 0.1).values())) < sum(map(len, cands.values()))


@pytest.mark.parametrize("n_iter,eval_thr,eval_profile", [(3, 0.1, 1e-3)])
def test_search_iterative_matches_jax(tiny, n_iter, eval_thr, eval_profile):
    """Three rounds, the intermediate ones at --e-profile (below -e)."""
    db, jdb, _cands, _ = tiny
    kw = dict(num_iterations=n_iter, eval_thr=eval_thr,
              eval_profile=eval_profile, cov_thr=0.0, cov_mode=0,
              aln_len_thr=0)
    rounds: list = []
    got = iterative.search_iterative(
        db, db, iterative.IterativeSearchConfig(**kw), same_qt_db=True,
        device="cpu", metrics=rounds)
    ref = jax_it.search_iterative(jdb, jdb, jax_it.IterativeSearchConfig(**kw),
                                  same_qt_db=True)
    assert_equal(got, ref)
    assert [m["round"] for m in rounds] == list(range(n_iter))
    assert "realign_detail" in rounds[0] and "align_detail" in rounds[-1]
    assert all("profiles_s" in m for m in rounds[:-1])
    # the profile rounds found records of their own
    assert n_records(got) > rounds[0]["records"]
    assert sum(m["records"] for m in rounds) == n_records(got)


# ------------------------------------------------ profile-profile traceback
def test_banded_align_profile_profile_matches_jax():
    """The PROFILE_PROFILE traceback binding on the JAX package's cases:
    identical profiles, a 4-residue insertion, an asymmetric cell."""
    from spacedust_tpu.native import banded_align_profile_profile as jax_pp
    rng = np.random.default_rng(3)
    go, ge = 11, 1
    Lq = 40
    qcons = rng.integers(0, 20, Lq).astype(np.uint8)
    qprof = np.full((20, Lq), -4, np.int8)
    qprof[qcons, np.arange(Lq)] = 8
    ins = rng.integers(0, 20, 4).astype(np.uint8)
    tcons = np.concatenate([qcons[:20], ins, qcons[20:]])
    tprof = np.full((20, len(tcons)), -4, np.int8)
    tprof[tcons, np.arange(len(tcons))] = 8
    tprof2 = qprof.copy()
    tprof2[qcons, np.arange(Lq)] = 2
    cases = [
        ((qcons, qcons, qprof, 0, qprof, 0, 8 * Lq), "M" * Lq),
        ((tcons, qcons, qprof, 0, tprof, 0, 8 * Lq - go - 3 * ge),
         "M" * 20 + "D" * 4 + "M" * 20),
        ((qcons, qcons, qprof, 0, tprof2, 0, 5 * Lq), "M" * Lq),
        # a sub-rectangle: the profiles are read from the start offsets
        ((tcons[27:40], qcons[23:36], qprof, 23, tprof, 27, 8 * 13),
         "M" * 13),
    ]
    for args, want in cases:
        got = banded_align_profile_profile(*args, go, ge)
        assert got == jax_pp(*args, go, ge) == want
