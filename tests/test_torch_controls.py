"""The alignment controls of the port (--max-accept, --max-rejected,
--alt-ali; SW on the CPU, plain version) against the JAX package on the
same candidates: the record lists must be equal, not close, in content
and in order.  Inputs are seeded: `synth.py`'s tiny repeat set, whose
homologs carry tandem copies of a segment so that alternative alignments
exist, and planted pairs."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.search.alignment import AlignmentEngine as JaxEngine
from spacedust_tpu.search.alignment import AlignmentParams as JaxParams
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.constants import AA_ORDER, X_INDEX
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.native import banded_align_batch
from spacedust_tpu_torch.ops import sw_cuda
from spacedust_tpu_torch.ops.sw import sw_jobs_ref
from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
from spacedust_tpu_torch.search.alignment import (AlignmentEngine,
                                                  AlignmentParams, _ranges)
from spacedust_tpu_torch.search.prefilter import PrefilterEngine
from spacedust_tpu_torch.search.records import AlnRecord
from spacedust_tpu_torch.stats.submat import load_substitution_matrix

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

INF = 2147483647


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
def tiny(tmp_path_factory):
    """The tiny repeat set with its prefilter candidates, three random
    candidates (mostly rejected) mixed into each query's list."""
    fastas = synth.write_genome_set(tmp_path_factory.mktemp("tiny"),
                                    "repeats_tiny")
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    hits = PrefilterEngine(db, db).match_all()
    rng = np.random.default_rng(11)
    cands = {}
    for qk, hs in hits.items():
        lst = [h.seq_id for h in hs]
        for extra in rng.integers(0, db.size, 3).tolist():
            if extra not in lst:
                lst.insert(int(rng.integers(0, len(lst) + 1)), extra)
        cands[qk] = lst
    return db, jdb, cands


def fragments(cands: dict) -> list[dict]:
    """The candidates split over three fragments; the lists of the first
    half of the queries are cut in two, so that a query's candidates span
    fragments."""
    qks = list(cands)
    half = len(qks) // 2
    first = {qk: cands[qk][:len(cands[qk]) // 2] for qk in qks[:half]}
    second = {qk: cands[qk][len(cands[qk]) // 2:] for qk in qks[:half]}
    return [first, second, {qk: cands[qk] for qk in qks[half:]}]


def run(engine, frags: list[dict]):
    st = engine.stream()
    for frag in frags:
        st.add(frag)
    return st.finish()


CONTROLS = [(1, INF, 0), (3, INF, 0), (INF, 1, 0), (INF, 2, 0),
            (INF, INF, 1), (INF, INF, 2), (3, 2, 2), (1, 1, 1), (3, 1, 2)]


@pytest.mark.parametrize("split", [False, True],
                         ids=["one-fragment", "three-fragments"])
@pytest.mark.parametrize("max_accept,max_rejected,alt", CONTROLS)
def test_align_all_controls_match_jax(tiny, max_accept, max_rejected, alt,
                                      split):
    db, jdb, cands = tiny
    kw = dict(max_accept=max_accept, max_rejected=max_rejected,
              alt_alignments=alt)
    frags = fragments(cands) if split else [cands]
    got = run(AlignmentEngine(db, db, AlignmentParams(**kw), device="cpu"),
              frags)
    ref = run(JaxEngine(jdb, jdb, JaxParams(**kw)), frags)
    assert_equal(got, ref)
    # a query's fragments are stepped through in order: as one list
    whole = AlignmentEngine(db, db, AlignmentParams(**kw),
                            device="cpu").align_all(cands)
    assert {qk: tuples(v) for qk, v in got.items()} == \
        {qk: tuples(v) for qk, v in whole.items()}
    # the control changed the result (nothing here is tested vacuously)
    base = AlignmentEngine(db, db, AlignmentParams(),
                           device="cpu").align_all(cands)
    if alt == 0:
        assert n_records(got) <= n_records(base)
        if max_accept == 1 or max_rejected != INF:
            assert n_records(got) < n_records(base)
    if max_accept == INF and max_rejected == INF:
        assert n_records(got) - n_records(base) >= (10 if alt == 2 else 8)
    if max_accept != INF:
        assert max(len(v) for v in got.values()) <= max_accept * (1 + alt)


def test_jax_yields_alt_records_on_the_repeat_sets(tiny):
    """The reference finds >= 10 alternative alignments on the tiny set
    (live) and on `repeats` (recorded), so --alt-ali has work to do."""
    from pathlib import Path
    _db, jdb, cands = tiny
    base = JaxEngine(jdb, jdb, JaxParams()).align_all(cands)
    alt = JaxEngine(jdb, jdb, JaxParams(alt_alignments=2)).align_all(cands)
    assert n_records(alt) - n_records(base) >= 10
    fixture = (Path(__file__).parent / "fixtures"
               / "torch_port_repeats_search_alt.tsv").read_text()
    pairs = [tuple(ln.split("\t")[:2]) for ln in fixture.splitlines()]
    assert len(pairs) - len(set(pairs)) >= 10


# ------------------------------------------------------------ planted pairs
def planted_db(tmp_path, genes: list[np.ndarray]):
    """A one-genome setDB of both packages from token arrays."""
    path = tmp_path / "planted.faa"
    synth.write_fasta(path, "PLANT_000001.1", [(g, 1) for g in genes])
    return create_setdb_from_fastas([path]), jax_fastas([path])


def protein(rng, n: int) -> np.ndarray:
    seq = rng.integers(0, 20, n).astype(np.uint8)
    seq[0] = AA_ORDER.index("M")
    return seq


def test_consecutive_rejections_reset_on_acceptance(tmp_path):
    """--max-rejected counts consecutive rejections: an acceptance sets
    the count back, and a query stops for good once it reaches the
    limit."""
    rng = np.random.default_rng(3)
    q = protein(rng, 150)
    homs = [q.copy() for _ in range(3)]
    for h in homs:
        hit = rng.integers(0, 100, len(h)) < 20
        h[hit] = rng.integers(0, 20, int(hit.sum()))
    junk = [protein(rng, 150) for _ in range(4)]
    db, jdb = planted_db(tmp_path, [q] + homs + junk)
    h1, h2, h3 = 1, 2, 3
    j1, j2, j3, j4 = 4, 5, 6, 7

    def accepted(cand, **kw):
        got = AlignmentEngine(db, db, AlignmentParams(**kw),
                              device="cpu").align_all({0: cand})
        ref = JaxEngine(jdb, jdb, JaxParams(**kw)).align_all({0: cand})
        assert_equal(got, ref)
        return sorted(r.tkey for r in got[0])

    # every junk candidate is a rejection on its own
    assert accepted([j1, j2, j3, j4]) == []
    # one rejection between acceptances never reaches 2 in a row
    assert accepted([h1, j1, h2, j2, h3], max_rejected=2) == [h1, h2, h3]
    # two in a row stop the query: h3 is never looked at
    assert accepted([h1, j1, h2, j2, j3, h3], max_rejected=2) == [h1, h2]
    # ... and the stop is final, not a count that a later hit could reset
    assert accepted([j1, j2, h1], max_rejected=2) == []
    # the identity hit is an acceptance: it resets the count
    assert accepted([j1, 0, j2, h1], max_rejected=2) == [0, h1]
    # both limits together: the second acceptance ends the query
    assert accepted([h1, j1, h2, h3], max_accept=2, max_rejected=2) \
        == [h1, h2]


def per_pair_loop(eng: AlignmentEngine, accepted: dict) -> dict:
    """computeAlternativeAlignment as a straight loop, one masked pair at
    a time, over the plain SW version and single-pair tracebacks: what
    the engine's rounds must equal, append order included."""
    from spacedust_tpu_torch.search.alignment import (_cov_vec,
                                                      _has_coverage_vec)
    par, qdb, tdb = eng.par, eng.qdb, eng.tdb
    qdata = torch.from_numpy(np.array(qdb.seq_data, dtype=np.uint8))
    qbias = torch.from_numpy(np.array(eng._qbias_all(), dtype=np.int8))
    sub8 = eng.matrix.sub_int.astype(np.int8)
    sub = torch.from_numpy(sub8)
    one = np.ones(1, np.int64)

    def cov_ok(qs, qe, ts, te, ql, tl):
        qcov = _cov_vec(qs * one, qe * one, ql * one)
        tcov = _cov_vec(ts * one, te * one, tl * one)
        return (bool(_has_coverage_vec(par.cov_thr, par.cov_mode, qcov,
                                       tcov)[0]), float(qcov[0]),
                float(tcov[0]))

    def align(qk, tk, tseq):
        ql, tl = int(qdb.lengths[qk]), len(tseq)
        tdata = torch.from_numpy(tseq.copy())
        job = np.array([[qdb.offsets[qk]], [ql], [0], [tl], [-1]], np.int64)
        score, t_end, q_end = (int(v) for v in sw_jobs_ref(
            qdata, qbias, tdata, sub, job, par.gap_open, par.gap_extend,
            reverse=False)[:3, 0])
        if t_end < 0:
            return None
        evalue = float(eng.evaluer.compute_evalue(score, ql))
        if evalue > par.eval_thr or not cov_ok(0, q_end, 0, t_end, ql,
                                               tl)[0]:
            return None
        job = np.array([[qdb.offsets[qk]], [q_end + 1], [0], [t_end + 1],
                        [score]], np.int64)
        _s, _gj, _gi, found, fj, fi = (int(v) for v in sw_jobs_ref(
            qdata, qbias, tdata, sub, job, par.gap_open, par.gap_extend,
            reverse=True)[:, 0])
        if not found:
            return None
        q_start, t_start = q_end - fi, t_end - fj
        ok, qcov, tcov = cov_ok(q_start, q_end, t_start, t_end, ql, tl)
        if not ok:
            return None
        ops, ident, _cig = banded_align_batch(
            np.array(qdb.seq_data, dtype=np.uint8),
            np.array(qdb.offsets[:-1], dtype=np.int64), tseq,
            np.zeros(1, np.int64), np.array(eng._qbias_all(), np.int8),
            sub8, [qk], [0], [q_start], [q_end], [t_start], [t_end],
            [score], par.gap_open, par.gap_extend)
        seq_id = np.float32(int(ident[0])) / np.float32(len(ops[0]))
        if not (evalue <= par.eval_thr
                and seq_id >= np.float32(par.seq_id_thr)
                and len(ops[0]) >= par.aln_len_thr):
            return None
        return AlnRecord(
            tkey=tk, score=int(eng.evaluer.compute_bit_score(score) + 0.5),
            seq_id=float(seq_id), evalue=evalue, qstart=q_start, qend=q_end,
            qlen=ql, tstart=t_start, tend=t_end, tlen=tl, backtrace=ops[0],
            raw_score=score, qcov=qcov, tcov=tcov)

    out = {}
    for qk, recs in accepted.items():
        lst = list(recs)
        for rec in recs:
            if rec.tkey == qk:
                continue
            tseq = np.array(tdb.sequence(rec.tkey), dtype=np.uint8)
            tseq[rec.tstart:rec.tend] = X_INDEX
            for _ in range(par.alt_alignments):
                new = align(qk, rec.tkey, tseq)
                if new is None:
                    break
                lst.append(new)
                tseq[new.tstart:new.tend] = X_INDEX
        out[qk] = sorted(lst, key=lambda r: (r.evalue, -r.score, r.tlen,
                                             r.tkey))
    return out


def test_masked_rounds_equal_per_pair_loop(tiny):
    db, _jdb, cands = tiny
    base = AlignmentEngine(db, db, AlignmentParams(),
                           device="cpu").align_all(cands)
    eng = AlignmentEngine(db, db, AlignmentParams(alt_alignments=2),
                          device="cpu")
    got = eng.align_all(cands)
    want = per_pair_loop(eng, base)
    assert list(got) == list(want)
    for qk in want:
        assert tuples(got[qk]) == tuples(want[qk]), qk
    m = eng.alt_metrics
    n_alt = n_records(got) - n_records(base)
    assert n_alt >= 10
    # two rounds, the second over the chains that the first kept alive;
    # a forward stage a round
    assert len(m["round_pairs"]) == 2
    assert m["round_pairs"][0] == sum(1 for qk, v in base.items()
                                      for r in v if r.tkey != qk)
    assert 0 < m["round_pairs"][1] < m["round_pairs"][0]
    assert m["fwd_pairs"] == sum(m["round_pairs"])
    assert m["n_batches"] == 4


def test_exact_copies_tie_in_round_order(tmp_path):
    """A target of three exact copies of the query: the parent and its two
    alternative alignments tie on E-value, score, target length and key,
    and stay in the order they were found in."""
    rng = np.random.default_rng(8)
    q = protein(rng, 90)
    db, jdb = planted_db(tmp_path, [q, np.concatenate([q, q, q]),
                                    protein(rng, 200)])
    kw = dict(alt_alignments=2)
    got = AlignmentEngine(db, db, AlignmentParams(**kw),
                          device="cpu").align_all({0: [1, 2]})
    ref = JaxEngine(jdb, jdb, JaxParams(**kw)).align_all({0: [1, 2]})
    assert_equal(got, ref)
    recs = got[0]
    assert [r.tkey for r in recs] == [1, 1, 1]
    assert len({(r.evalue, r.score) for r in recs}) == 1
    assert [r.tstart for r in recs] == [0, 90, 180]


def test_end_column_stays_unmasked(tmp_path):
    """The mask is [tstart, tend): the parent's end column stays, and an
    alternative alignment may start on it.  Query U + junk + S against
    target U[:79] + S, where S begins with U's last letter: the parent is
    U on columns 0..79, and S realigns from column 79, not 80."""
    rng = np.random.default_rng(23)
    # the junk is long enough that no gap bridges it
    u, s, junk = protein(rng, 80), protein(rng, 50), protein(rng, 400)
    s[0] = u[79]
    q = np.concatenate([u, junk, s])
    t = np.concatenate([u[:79], s, protein(rng, 20)])
    db, jdb = planted_db(tmp_path, [q, t])
    kw = dict(alt_alignments=1)
    got = AlignmentEngine(db, db, AlignmentParams(**kw),
                          device="cpu").align_all({0: [1]})
    ref = JaxEngine(jdb, jdb, JaxParams(**kw)).align_all({0: [1]})
    assert_equal(got, ref)
    parent, alt = sorted(got[0], key=lambda r: r.tstart)
    assert (parent.qstart, parent.qend, parent.tstart, parent.tend) \
        == (0, 79, 0, 79)
    assert (alt.tstart, alt.tend) == (parent.tend, 79 + 49)
    assert (alt.qstart, alt.qend) == (480, 529)
    # a record of a masked round prints its CIGAR from the backtrace
    assert alt.cigar is None and alt.columns()[-1] == "50M"


# --------------------------------------------------------- engine and synth
def test_with_targets_shares_the_queries():
    rng = np.random.default_rng(2)
    sub = load_substitution_matrix().sub_int
    q = rng.integers(0, 20, 300).astype(np.uint8)
    qb = np.zeros(300, np.int8)
    t = rng.integers(0, 20, 400).astype(np.uint8)
    dev = DeviceAlignDB(q, qb, t, sub, device="cpu")
    masked = np.concatenate([q[50:250], q[:120]])
    masked[:30] = X_INDEX            # a run at the start
    masked[100:140] = X_INDEX        # in the middle
    masked[198] = X_INDEX            # the last column but one
    masked[200:] = X_INDEX           # a target masked whole
    view = dev.with_targets(masked)
    assert view.qdata is dev.qdata and view.qbias is dev.qbias
    assert view.sub is dev.sub and view.tdata is not dev.tdata
    assert view.metrics is not dev.metrics
    job = (np.array([0, 0]), np.array([300, 300]), np.array([0, 200]),
           np.array([200, 120]), np.array([-1, -1]), np.arange(2))
    (pos, out), = view.run_buckets([job], 11, 1, reverse=False)
    jobs = np.array([[0, 0], [300, 300], [0, 200], [200, 120], [-1, -1]],
                    np.int64)
    want = sw_jobs_ref(view.qdata, view.qbias, view.tdata, view.sub, jobs,
                       11, 1, reverse=False).numpy()
    assert np.array_equal(np.stack(out)[:, np.argsort(pos)], want)
    assert want[0, 0] > 100 and want[0, 1] == 0 and want[1, 1] == -1
    assert dev.metrics["fwd_pairs"] == 0 and view.metrics["fwd_pairs"] == 2
    with pytest.raises(ValueError, match="alphabet"):
        dev.with_targets(np.full(5, 21, np.uint8))


def test_kernel_and_wrapper_times_are_kept_apart():
    """The engine reports the launches' time and the wrapper's total; on
    the CPU no event is recorded and both stay 0."""
    sub = load_substitution_matrix().sub_int
    q = np.arange(40, dtype=np.uint8) % 20
    dev = DeviceAlignDB(q, np.zeros(40, np.int8), q, sub, device="cpu")
    job = (np.array([0]), np.array([40]), np.array([0]), np.array([40]),
           np.array([-1]), np.arange(1))
    dev.run_buckets([job], 11, 1, reverse=False)
    for key in ("fwd_kernel_ms", "fwd_wrapper_ms", "rev_kernel_ms",
                "rev_wrapper_ms"):
        assert dev.metrics[key] == 0.0
    events: dict = {}
    sw_cuda.sw_forward(dev.qdata, dev.qbias, dev.tdata, dev.sub,
                       np.array([[0], [40], [0], [40], [-1]], np.int64),
                       11, 1, events=events)
    assert events == {}


def test_ranges():
    assert _ranges(np.array([5, 0, 9]), np.array([2, 0, 3])).tolist() \
        == [5, 6, 9, 10, 11]
    assert _ranges(np.array([], np.int64), np.array([], np.int64)).size == 0


SYNTH_SHA256 = {
    ("small", "genome_a.faa"):
        "2e803b1a23e5fdcdd7c581aa9a614a4e5dc31313f3bfbdb9e9e048ed05069a53",
    ("small", "genome_b.faa"):
        "c07d63874fd23272329d260fbb923aa2514d224a1230bffa06528bc3b73bf817",
    ("real", "genome_a.faa"):
        "be4159ecb9a0ff9fe48a03e29a21798495803229c6eec1c642d95a2e3fd704b4",
    ("real", "genome_b.faa"):
        "dd011c189993d0146c59d02578111752ac4e30c431e325c5a47d564f1efae459",
}


STRUCT_SHA256 = {
    "genomes":
        "ee202417d56179387f803f898266507aecee967104dbf10a07f8a163eba21ef9",
    "genomes_ss":
        "5a0942bce78e28709391ceafad45997666cf1d55c6498f9e04fa7f5aa7ba1fc2",
    "genomes_h":
        "213f5c139dc49db91e8f41844207ed2e32fc9f0663c5a9e0327547bf28e25347",
    "ref":
        "832025ca28a818c7449ed8efff4ac13f96b9bc52ac2b6212b30c9f07f276a160",
    "ref_ss":
        "029f11e2e3f4b27ae24a45abad67b73126df70fba64002ba9378aeb6c9a0a75f",
}


@pytest.mark.parametrize("size", ["small", "real"])
def test_synth_sequence_sets_unchanged(tmp_path, size):
    """The repeat sets were added beside the old sizes: those still write
    the bytes the recorded fixtures were made from."""
    for path in synth.write_genome_set(tmp_path, size):
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        assert digest == SYNTH_SHA256[size, path.name]


def test_synth_struct_set_unchanged(tmp_path):
    synth.write_struct_set(tmp_path, "small")
    got = {name: hashlib.sha256((tmp_path / name).read_bytes()).hexdigest()
           for name in ("genomes", "genomes_ss", "genomes_h", "ref",
                        "ref_ss")}
    assert got == STRUCT_SHA256
