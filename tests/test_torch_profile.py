"""The port's profile-query search on the CPU against the JAX package: the
plain version of the profile kernels (ops/sw.py::sw_prof_jobs_ref) against
JAX B10 (ops/sw.py::sw_forward_from_profiles / sw_reverse_from_profiles),
the kernels' lane schedule with the profile cell (the numpy lane_model of
test_torch_sw.py), MSA / MSA filter / PSSM, the target-profile prefilter,
the swapped profile search and its sliced form, expandaln.  Tolerance 0
everywhere: the DP is integer and the PSSM code is float32 numpy (or its
native twin) operation for operation."""

from pathlib import Path

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.ops.sw import (sw_forward_from_profiles,
                                  sw_reverse_from_profiles)
from spacedust_tpu.search import profile as jax_profile
from spacedust_tpu.search.alignment import AlignmentEngine as JaxEngine
from spacedust_tpu.search.alignment import AlignmentParams as JaxParams
from spacedust_tpu.search.expandaln import (
    ExpandParams as JaxExpandParams, expand_alignments as jax_expand,
    translate_backtrace as jax_translate)
from spacedust_tpu.search.msafilter import filter_msa as jax_filter_msa
from spacedust_tpu.search.profilesearch import (
    ProfileSearchParams as JaxPSParams,
    TargetProfilePrefilter as JaxTPF,
    search_profile_target as jax_search)
from spacedust_tpu.workflow.clusterdb import ClusterDB as JaxClusterDB
from spacedust_tpu.workflow.clusterdb import cluster_db as jax_cluster_db
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.ops import sw_cuda
from spacedust_tpu_torch.ops.sw import PROF_COLS, sw_prof_jobs_ref
from spacedust_tpu_torch.ops.sw_engine import ProfileDeviceDB
from spacedust_tpu_torch.search import profile
from spacedust_tpu_torch.search.alignment import (AlignmentEngine,
                                                  AlignmentParams)
from spacedust_tpu_torch.search.expandaln import (ExpandParams,
                                                  expand_alignments,
                                                  translate_backtrace)
from spacedust_tpu_torch.search.msafilter import filter_msa
from spacedust_tpu_torch.search.profilesearch import (
    ProfileSearchParams, TargetProfilePrefilter, profile_slices,
    search_profile_target, search_profile_target_sliced)
from spacedust_tpu_torch.stats.submat import (load_pinned_matrix,
                                              load_substitution_matrix)
from spacedust_tpu_torch.workflow.clusterdb import ClusterDB

from test_torch_clusterdb import homolog_fastas
from test_torch_sw import FAULTS, GE, GO, ROWS, _chip_smoke, lane_model

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


# ----------------------------------------------------- B10, plain version
def prof_resident(seed: int, n: int = 14):
    """Seeded ragged profile-query pairs: resident (n, 21) int8 profile
    rows and target tokens, and (5, n) forward jobs.  Pair 0 has a 1-row
    query, pair 1 a query past one strip (> 512 rows), pairs 2-3 score 0
    (all values negative), pair 4 holds a motif twice in its target
    (tied maxima), the rest are homologs (profile = substitution rows of
    a query, target = its mutated copy) with values clipped to -32..31."""
    rng = np.random.default_rng(seed)
    sub = load_substitution_matrix().sub_int
    qlens = rng.integers(5, 160, n)
    qlens[0], qlens[1] = 1, 600
    tlens = rng.integers(5, 140, n)
    profs, ts = [], []
    for p in range(n):
        q = rng.integers(0, 20, qlens[p])
        prof = np.clip(sub[q].astype(np.int32)
                       + rng.integers(-3, 4, (qlens[p], PROF_COLS)), -32, 31)
        if p in (2, 3):
            prof = -rng.integers(1, 33, prof.shape)
        if p == 4:
            m = q[:min(qlens[p] // 2, 20)]
            t = np.concatenate([m, rng.integers(0, 20, 7), m])
        elif p >= 5:
            lo = int(rng.integers(0, max(qlens[p] - tlens[p], 0) + 1))
            t = q[lo:lo + tlens[p]].copy()
            hit = rng.integers(0, 100, len(t)) < 20
            t[hit] = rng.integers(0, 21, int(hit.sum()))
        else:
            t = rng.integers(0, 21, tlens[p])
        profs.append(prof.astype(np.int8))
        ts.append(t.astype(np.uint8))
    qlen = np.array([len(x) for x in profs], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    jobs = np.stack([np.cumsum(qlen) - qlen, qlen, np.cumsum(tlen) - tlen,
                     tlen, np.full(n, -1)]).astype(np.int64)
    return np.concatenate(profs), np.concatenate(ts), jobs


def _plain(rows, t, jobs, reverse):
    return sw_prof_jobs_ref(torch.from_numpy(rows.reshape(-1)),
                            torch.from_numpy(t), jobs, GO, GE,
                            reverse).numpy()


def _jax_b10(rows, t, jobs, reverse):
    """JAX B10 over explicit (B, 21, Lq) int32 profiles, as the JAX
    alignment engine's host path builds them (_run_forward_host /
    _run_reverse_host): the reverse pass flips the profile's prefix and
    the target's.  Returns (score, t_end, q_end) or (score, fj, fi,
    found)."""
    n = jobs.shape[1]
    Lq, Lt = int(jobs[1].max()), int(jobs[3].max())
    prof = np.zeros((n, PROF_COLS, Lq), np.int32)
    tarr = np.zeros((n, Lt), np.int32)
    for p in range(n):
        qo, ql, to, tl = (int(x) for x in jobs[:4, p])
        pr, tt = rows[qo:qo + ql].T, t[to:to + tl]
        if reverse:
            pr, tt = pr[:, ::-1], tt[::-1]
        prof[p, :, :ql] = pr
        tarr[p, :tl] = tt
    if reverse:
        s, fj, fi, found = sw_reverse_from_profiles(
            prof, tarr, jobs[3], jobs[1], jobs[4], GO, GE)
        return np.stack([s, fj, fi, found.astype(np.int64)])
    s, q_end, t_end = sw_forward_from_profiles(prof, tarr, jobs[3], jobs[1],
                                               GO, GE)
    return np.stack([s, t_end, q_end])


def _reverse_jobs(jobs, fwd):
    keep = np.nonzero(fwd[0] > 0)[0]
    return np.stack([jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep],
                     fwd[1, keep] + 1, fwd[0, keep]]).astype(np.int64)


def test_prof_plain_matches_jax_b10():
    """sw_prof_jobs_ref equals JAX sw_forward_from_profiles and, on the
    derived prefix jobs, sw_reverse_from_profiles: all outputs."""
    rows, t, jobs = prof_resident(5)
    fwd = _plain(rows, t, jobs, False)
    np.testing.assert_array_equal(fwd[:3], _jax_b10(rows, t, jobs, False))
    assert (fwd[3] == 0).all() and (fwd[4] == -1).all()
    assert fwd[0, 2] == fwd[0, 3] == 0 and fwd[0, 1] > 0 and fwd[1, 0] >= 0
    rj = _reverse_jobs(jobs, fwd)
    rev = _plain(rows, t, rj, True)
    want = _jax_b10(rows, t, rj, True)
    np.testing.assert_array_equal(rev[[0, 4, 5, 3]], want)
    assert rev[3].all() and len(rj[0]) >= 10


def test_prof_wrapper_cpu_takes_plain_version_and_checks():
    """On CPU tensors the profile wrappers run the plain version and count
    no launch; malformed profile rows or jobs raise."""
    rows, t, jobs = prof_resident(6)
    P, T = torch.from_numpy(rows.reshape(-1)), torch.from_numpy(t)
    before = sw_cuda.LAUNCHES.copy()
    for reverse, fn in ((False, sw_cuda.sw_forward_prof),
                        (True, sw_cuda.sw_reverse_prof)):
        np.testing.assert_array_equal(fn(P, T, jobs, GO, GE).numpy(),
                                      _plain(rows, t, jobs, reverse))
    assert sw_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_prof(P[:-1], T, jobs, GO, GE)    # not 21 a row
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_prof(P.to(torch.int16), T, jobs, GO, GE)
    bad = jobs.copy()
    bad[1, -1] = len(rows)                                  # past the rows
    with pytest.raises(ValueError):
        sw_cuda.sw_forward_prof(P, T, bad, GO, GE)
    with pytest.raises(ValueError):
        ProfileDeviceDB(rows[:, :20].copy(), t, device="cpu")


def test_profile_engine_and_with_targets():
    """ProfileDeviceDB on the CPU: run_buckets gives the plain version's
    outputs per position, and with_targets scores the same queries against
    another target array."""
    rows, t, jobs = prof_resident(7)
    eng = ProfileDeviceDB(rows, t, device="cpu")
    pos = np.arange(jobs.shape[1], dtype=np.int64)
    want = _plain(rows, t, jobs, False)
    for p, out in eng.run_buckets([(*jobs, pos)], GO, GE, reverse=False):
        np.testing.assert_array_equal(np.stack(out)[:, np.argsort(p)], want)
    assert eng.metrics["fwd_pairs"] == jobs.shape[1]
    t2 = t[::-1].copy()
    view = eng.with_targets(t2)
    assert view.qprof is eng.qprof
    got = view.run_buckets([(*jobs, pos)], GO, GE, reverse=False)
    p, out = got[0]
    np.testing.assert_array_equal(np.stack(out)[:, np.argsort(p)],
                                  _plain(rows, t2, jobs, False))


# ------------------------------------- the lane schedule, profile cell
def prof_slots(R: int) -> np.ndarray:
    """(32, R) byte offsets of lane l's row r within a token's 32 R bytes
    of the warp's shared region, as csrc/sw.cu lays them out: lane l's
    block starts at l R, its R / 4 words rotated by l (R / 4) / 32 when
    R / 4 is even."""
    q = R // 4
    lane = np.arange(32)[:, None]
    r = np.arange(R)[None, :]
    rot = (lane * q >> 5) if q % 2 == 0 else 0 * lane
    return lane * R + 4 * ((r // 4 + rot) % q) + r % 4


def _prof_cell(rows, job, R, reverse):
    """(qlen, cell function) and the target tokens of one job as the
    profile kernels form them: at each strip's start a lane writes its R
    profile rows (flipped for reverse) into its slots of a token-major
    region, and a cell reads its row's byte for the column's token."""
    qoff, qlen, toff, tlen = (int(x) for x in job[:4])
    prof = rows[qoff:qoff + qlen].astype(np.int64)
    if reverse:
        prof = prof[::-1]
    slots = prof_slots(R)
    strip = [None, None]            # the strip's rows and its region

    def cell(srow, tok):
        if strip[0] is not srow:    # a new strip: the lanes copy their rows
            region = np.full(PROF_COLS * 32 * R, 99, np.int64)   # junk
            for t in range(PROF_COLS):
                region[t * 32 * R + slots] = prof[srow, t]
            strip[:] = srow, region
        return strip[1][tok[:, None] * 32 * R + slots]

    return (qlen, cell)


def _prof_model_jobs(rows, t, jobs, R, reverse, fault=None):
    out = []
    for p in range(jobs.shape[1]):
        toff, tlen = int(jobs[2, p]), int(jobs[3, p])
        tt = t[toff:toff + tlen].astype(np.int64)
        out.append(lane_model(_prof_cell(rows, jobs[:, p], R, reverse), GO,
                              GE, int(jobs[4, p]), R, reverse, fault,
                              tt[::-1] if reverse else tt))
    return np.array(out).T


@pytest.mark.parametrize("R", ROWS)
def test_prof_slots_are_one_to_one_and_conflict_free(R):
    """The slot layout keeps every row apart, stays inside its token's
    bytes, and puts the 32 lanes' reads of one row in 32 banks (4-byte
    words mod 32) at every class."""
    slots = prof_slots(R)
    assert len(np.unique(slots)) == 32 * R and slots.max() < 32 * R
    for r in range(R):
        assert len(np.unique((slots[:, r] // 4) % 32)) == 32, r


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_prof_lane_model_matches_plain_ragged(R, reverse):
    """Seeded ragged profile pairs through the lane model with the
    profile cell at class R, against sw_prof_jobs_ref."""
    rows, t, jobs = prof_resident(30 + R, n=10)
    fwd = _plain(rows, t, jobs, False)
    if reverse:
        jobs = _reverse_jobs(jobs, fwd)
        want = _plain(rows, t, jobs, True)
        assert want[3].all() and jobs.shape[1] >= 5
    else:
        want = fwd
        assert (fwd[0] == 0).any() and (jobs[1] > 32 * R).any()
    got = _prof_model_jobs(rows, t, jobs, R, reverse)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])


def _edge(R):
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    (flat, t), jobs, expect = smoke.edge_batch_prof(R, sub)
    return smoke, flat.reshape(-1, PROF_COLS), t, jobs, expect


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_prof_lane_model_matches_plain_edges(R, reverse):
    """The smoke run's boundary shapes and planted ties as profile rows
    (chip_smoke.py::edge_batch_prof): the ties come out of the plain
    version where the design puts them, and the model agrees on every
    pair, forward, reverse on the whole pairs and on the prefixes."""
    smoke, rows, t, jobs, expect = _edge(R)
    fwd = _plain(rows, t, jobs, False)
    for p, want in expect.items():
        assert tuple(fwd[:3, p]) == want, (p, fwd[:3, p], want)
    if not reverse:
        np.testing.assert_array_equal(
            _prof_model_jobs(rows, t, jobs, R, False)[:3], fwd[:3])
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    derived = smoke.reverse_jobs(jobs, fwd)
    multi = derived[1] > 32 * R
    assert multi.sum() >= 4
    for js in (whole, derived):
        want = _plain(rows, t, js, True)
        np.testing.assert_array_equal(
            _prof_model_jobs(rows, t, js, R, True), want)
    assert want[3].all()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("R", ROWS)
def test_prof_edge_batch_exposes_planted_fault(R, fault):
    """edge_batch_prof tells the lane model with the profile cell and one
    fault planted from the plain version, at every class."""
    smoke, rows, t, jobs, expect = _edge(R)
    planted = jobs[:, sorted(expect)]
    fwd = _plain(rows, t, planted, False)
    if fault not in ("later_row_takes_tie", "strip_cmax_lost"):
        got = _prof_model_jobs(rows, t, planted, R, False, fault)
        assert (got[:3] != fwd[:3]).any()
        return
    whole = planted.copy()
    whole[4] = fwd[0]
    js = np.concatenate([whole, smoke.reverse_jobs(planted, fwd)], axis=1)
    want = _plain(rows, t, js, True)
    assert (_prof_model_jobs(rows, t, js, R, True, fault) != want).any()


# ------------------------------------------------ MSA, filter, PSSM
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    fa = homolog_fastas(tmp_path_factory.mktemp("ptiny"), seed=23)
    return create_setdb_from_fastas(fa), jax_fastas(fa)


@pytest.fixture(scope="module")
def tiny_cdb(tiny):
    """The JAX package's ClusterDB of the tiny set (the port's equals it:
    test_torch_clusterdb.py)."""
    return jax_cluster_db(tiny[1])


def test_msa_filter_pssm_match_jax(tiny, tiny_cdb):
    """compute_msa, filter_msa and compute_pssm (int8 PSSM, float32
    probabilities, Neff, consensus, query column) of every cluster of the
    tiny set, from the JAX package's rep->member records."""
    db, _ = tiny
    matrix = load_pinned_matrix("blosum62_bf2_bias")
    n_msa = 0
    for rep, recs in tiny_cdb.clu_aln.items():
        recs = [r for r in recs if r.tkey != rep]
        q = db.sequence(rep)
        targets = [db.sequence(r.tkey) for r in recs]
        msa = profile.compute_msa(q, targets, recs)
        np.testing.assert_array_equal(
            msa, jax_profile.compute_msa(q, targets, recs))
        keep = filter_msa(msa, sub_int=matrix.sub_int)
        np.testing.assert_array_equal(
            keep, jax_filter_msa(msa, sub_int=matrix.sub_int))
        got = profile.compute_pssm(q, targets, recs, matrix)
        want = jax_profile.compute_pssm(q, targets, recs, matrix)
        for name in ("pssm", "probs", "neff_m", "consensus", "query"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        n_msa += len(recs) > 0
    assert n_msa >= 3


@pytest.mark.parametrize("L", [1, 7, 40, 41, 333])
def test_pssm_loops_match_jax(L):
    """The two PSSM loops the port runs otherwise (the global bias
    correction, natively; the sequence weights, as a cumsum) against the
    JAX package's Python loops on seeded inputs: bit-equal."""
    rng = np.random.default_rng(L)
    p_back = load_substitution_matrix().p_back.astype(np.float32)
    for lo, hi in ((-5, 6), (-128, 128)):
        pssm = rng.integers(lo, hi, (L, 20)).astype(np.int8)
        np.testing.assert_array_equal(
            profile.global_aa_bias_correction(pssm, p_back),
            jax_profile.global_aa_bias_correction(pssm, p_back))
    for S in (1, 4, 17):
        msa = rng.integers(0, 21, (S, L)).astype(np.int8)
        msa[rng.integers(0, 100, (S, L)) < 30] = profile.GAP
        a = profile.compute_sequence_weights(msa)
        b = jax_profile.compute_sequence_weights(msa)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ profile search
def test_ranked_desc_sort20_matches_jax():
    """The sorting network of the profile k-mer tables, ties included
    (values drawn from a narrow range), equals the JAX package's."""
    from spacedust_tpu.search.prefilter import ranked_desc_sort20 as jax_sort
    from spacedust_tpu_torch.search.prefilter import ranked_desc_sort20
    rng = np.random.default_rng(3)
    for lo, hi in ((-3, 4), (-128, 128)):
        vals = rng.integers(lo, hi, (257, 20)).astype(np.int16)
        for a, b in zip(ranked_desc_sort20(vals), jax_sort(vals)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_target_profile_prefilter_matches_jax(tiny, tiny_cdb):
    """match_query of every gene equals the JAX prefilter's; the port's
    postings are the JAX index's restricted to the query genes' k-mers,
    in the same order."""
    db, jdb = tiny
    got = TargetProfilePrefilter(db, tiny_cdb, cov_thr=0.0)
    want = JaxTPF(jdb, tiny_cdb, cov_thr=0.0)
    for qk in range(db.size):
        assert got.match_query(qk) == want.match_query(qk), qk
    sel = TargetProfilePrefilter._query_kmer_table(db)[want.post_kmer] == 1
    for a, b in ((got.post_kmer, want.post_kmer), (got.post_rep,
                                                  want.post_rep),
                 (got.post_pos, want.post_pos)):
        np.testing.assert_array_equal(a, b[sel])
    assert sel.sum() > 100 and sum(len(got.match_query(k))
                                   for k in range(db.size)) >= db.size


def test_profile_queries_align_like_jax(tiny, tiny_cdb):
    """AlignmentEngine with query profiles (the swapped search's engine:
    representatives' profiles as queries against the genes) equals the
    JAX engine record for record, identities from the profiles' stored
    query residues."""
    db, jdb = tiny
    cands = {rep: list(range(db.size)) for rep in tiny_cdb.rep_keys}
    kw = dict(eval_thr=10.0, cov_thr=0.0)
    got = AlignmentEngine(db, db, AlignmentParams(**kw), same_qt_db=False,
                          query_profiles=tiny_cdb.aln_profiles,
                          query_profile_seqs=tiny_cdb.query_seqs,
                          device="cpu").align_all(cands)
    want = JaxEngine(jdb, jdb, JaxParams(**kw), same_qt_db=False,
                     query_profiles=tiny_cdb.aln_profiles,
                     query_profile_seqs=tiny_cdb.query_seqs
                     ).align_all(cands)
    assert list(got) == list(want)
    for qk in want:
        assert [r.line() for r in got[qk]] == [r.line() for r in want[qk]]
    assert sum(len(v) for v in got.values()) >= 2 * len(cands)


def test_profile_queries_trace_pair_by_pair(tiny, tiny_cdb):
    """Profile queries keep one traceback call a pair: their
    `align.traceback` spans name the route "per_pair", and every traced
    pair is counted as a per-pair call."""
    from spacedust_tpu_torch.utils import trace
    db, _jdb = tiny
    cands = {rep: list(range(db.size)) for rep in tiny_cdb.rep_keys[:4]}
    eng = AlignmentEngine(db, db, AlignmentParams(eval_thr=10.0,
                                                  cov_thr=0.0),
                          same_qt_db=False,
                          query_profiles=tiny_cdb.aln_profiles,
                          query_profile_seqs=tiny_cdb.query_seqs,
                          device="cpu")
    trace.start()
    try:
        eng.align_all(cands)
    finally:
        rec = trace.stop()
    spans = [s for s in rec.spans if s[0] == "align.traceback"]
    assert spans and all(s[4] == {"route": "per_pair"} for s in spans)
    n = {"traceback_pairs": 0, "traceback_pair_calls": 0}
    for name, _tid, _t, k in rec.counts:
        n[name] += k
    assert n["traceback_pair_calls"] == n["traceback_pairs"] > 0


def test_profile_query_identity_is_not_ported(tiny, tiny_cdb):
    """Ported since this test was named: the identity record of a profile
    query in a same-DB search (scoreIdentical over the profile rows)
    comes out of align_all as the JAX package's does."""
    from spacedust_tpu.search.alignment import AlignmentEngine as JaxEngine
    from spacedust_tpu.search.alignment import AlignmentParams as JaxParams
    db, jdb = tiny
    reps = tiny_cdb.rep_keys[:5]
    eng = AlignmentEngine(db, db, AlignmentParams(), same_qt_db=True,
                          query_profiles=tiny_cdb.aln_profiles, device="cpu")
    got = eng.align_all({rep: [rep] for rep in reps})
    want = JaxEngine(jdb, jdb, JaxParams(), same_qt_db=True,
                     query_profiles=tiny_cdb.aln_profiles).align_all(
        {rep: [rep] for rep in reps})
    for rep in reps:
        assert [r.line() for r in got[rep]] == [r.line() for r in want[rep]]
        assert [r.tkey for r in got[rep]] == [rep]


def test_search_profile_target_and_sliced_match_jax(tiny, tiny_cdb):
    """The swapped target-profile search (its E-values against the
    profile DB's residue count) equals the JAX package's record for
    record, and the memory-bounded slices equal the exhaustive search."""
    db, jdb = tiny
    metrics: dict = {}
    got = search_profile_target(db, db, tiny_cdb,
                                ProfileSearchParams(mask=False),
                                device="cpu", metrics=metrics)
    want = jax_search(jdb, jdb, tiny_cdb, JaxPSParams(mask=False))
    assert list(got) == list(want)
    for qk in want:
        assert [r.line() for r in got[qk]] == [r.line() for r in want[qk]]
    assert sum(len(v) for v in got.values()) >= db.size
    assert {"index_s", "match_s", "align_s", "swap_s"} <= set(metrics)
    limit = 2048 * 32
    assert len(profile_slices(tiny_cdb, limit)) > 1
    sliced = search_profile_target_sliced(db, db, tiny_cdb,
                                          ProfileSearchParams(mask=False),
                                          split_memory_limit=limit,
                                          device="cpu")
    for qk in got:
        assert [r.line() for r in sliced[qk]] == [r.line() for r in got[qk]]


def test_expandaln_matches_jax():
    """translate_backtrace and expand_alignments over the JAX-recorded
    clu_aln of the small set, with gene -> representative hits made by
    turning each member's record round (swap_record): every composed
    record equal, at two E-value gates."""
    from spacedust_tpu_torch.search.profilesearch import swap_record
    from spacedust_tpu_torch.stats.evalue import (BLOSUM62_GAPPED_11_1,
                                                  EvalueComputation)
    cdb = JaxClusterDB.load(FIXTURES / "torch_port_small_clu")
    ours = ClusterDB.load(FIXTURES / "torch_port_small_clu")
    ev = EvalueComputation(100_000, BLOSUM62_GAPPED_11_1)
    ab: dict = {}
    for rep in cdb.rep_keys:
        for r in cdb.clu_aln[rep]:
            ab.setdefault(r.tkey, []).append(swap_record(r, rep, ev))
    n = 0
    for recs in ab.values():
        for ab_rec in recs:
            for bc in ours.clu_aln[ab_rec.tkey]:
                assert translate_backtrace(ab_rec, bc) == jax_translate(
                    ab_rec, bc)
                n += 1
    assert n >= 300 + 20
    for thr in (1e-3, 10.0):
        got = expand_alignments(ab, ours.clu_aln, ExpandParams(eval_thr=thr))
        want = jax_expand(ab, cdb.clu_aln, JaxExpandParams(eval_thr=thr))
        assert sorted(got) == sorted(want)
        for qk in want:
            assert ([r.line() for r in got[qk]]
                    == [r.line() for r in want[qk]])
    assert sum(len(v) for v in got.values()) > len(ab)
