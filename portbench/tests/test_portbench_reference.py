"""The plain reference's DP against hand cases, a brute-force Gotoh, and
the program's plain SW; its tables against the raw files; the int8
control against the exact DP."""

import numpy as np
import pytest

from portbench.reference import scoring
from portbench.reference.sw import Pairs, align


def _sub(match=2, mismatch=-1, n=21):
    s = np.full((n, n), mismatch, dtype=np.int64)
    np.fill_diagonal(s, match)
    return s


def _one(q, t, sub, go, ge, qb=None, **kw):
    q, t = np.asarray(q), np.asarray(t)
    qb = np.zeros(len(q), np.int64) if qb is None else np.asarray(qb)
    out = align(Pairs([q], [qb], [t], sub), go, ge, "cpu", **kw)
    return tuple(int(out[k][0]) for k in
                 ("score", "q_start", "q_end", "t_start", "t_end"))


def brute(q, t, sub, qb, go, ge):
    """Gotoh cell by cell: (score, q_start, q_end, t_start, t_end) with the
    reference's end rule (first column whose maximum beats every earlier
    one, first row there) and start rule (on the flipped prefixes, first
    column reaching the score, first row there)."""
    def scan(q, t, qb, term):
        n, m = len(q), len(t)
        H = [[0] * (m + 1) for _ in range(n + 1)]
        E = [[-10**9] * (m + 1) for _ in range(n + 1)]
        F = [[-10**9] * (m + 1) for _ in range(n + 1)]
        best, bj, bi, found = 0, -1, 0, None
        for j in range(1, m + 1):
            for i in range(1, n + 1):
                s = int(np.int8(sub[q[i - 1], t[j - 1]] + qb[i - 1]))
                E[i][j] = max(E[i][j - 1] - ge, H[i][j - 1] - go)
                F[i][j] = max(F[i - 1][j] - ge, H[i - 1][j] - go)
                H[i][j] = max(0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            col = [H[i][j] for i in range(1, n + 1)]
            cmax = max(col)
            if cmax > best:
                best, bj, bi = cmax, j - 1, col.index(cmax)
            if found is None and cmax == term:
                found = (j - 1, col.index(cmax))
        return best, bj, bi, found
    score, te, qe, _ = scan(q, t, qb, -1)
    if score == 0:
        return 0, -1, -1, -1, -1
    _s, _j, _i, (fj, fi) = scan(q[:qe + 1][::-1], t[:te + 1][::-1],
                                qb[:qe + 1][::-1], score)
    return score, qe - fi, qe, te - fj, te


def test_identical():
    assert _one([0, 1, 2, 3], [0, 1, 2, 3], _sub(), 3, 1) == (8, 0, 3, 0, 3)


def test_gap_opened_once():
    q = [0] * 4 + [1] * 4
    t = [0] * 4 + [5] + [1] * 4
    # without the gap: 8 - 5 + 6 = 9 at (7, 7); with it 16 - 3 at (7, 8)
    assert _one(q, t, _sub(mismatch=-5), 3, 1) == (13, 0, 7, 0, 8)


def test_gap_too_dear_keeps_the_better_half():
    q = [0] * 4 + [1] * 5
    t = [0] * 4 + [5] * 6 + [1] * 5
    # a gap of 6 costs 20 + 5: the five 1s alone (10) beat 8 + 10 - 25
    assert _one(q, t, _sub(mismatch=-5), 20, 1) == (10, 4, 8, 10, 14)


def test_no_positive_cell():
    assert _one([0, 0], [1, 1], _sub(), 3, 1) == (0, -1, -1, -1, -1)


def test_first_end_column_wins_a_tie():
    # two equal local hits along t: the first column to reach 6 is kept
    assert _one([0, 1, 2], [0, 1, 2, 7, 7, 0, 1, 2], _sub(), 30, 30) \
        == (6, 0, 2, 0, 2)


def test_profile_wraps_to_int8():
    sub = _sub(match=100)
    # 100 + 60 wraps to -96: the bias turns the match into a loss
    assert _one([0, 0], [0, 0], sub, 3, 1, qb=[60, 0])[0] == 100


@pytest.mark.parametrize("seed", range(6))
def test_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    sub = rng.integers(-4, 8, (21, 21))
    for _ in range(4):
        q = rng.integers(0, 21, rng.integers(1, 14))
        t = rng.integers(0, 21, rng.integers(1, 14))
        qb = rng.integers(-2, 3, len(q))
        go, ge = int(rng.integers(2, 8)), int(rng.integers(1, 3))
        assert _one(q, t, sub, go, ge, qb=qb) == brute(q, t, sub, qb, go, ge)


def test_against_the_programs_plain_sw():
    """On BLOSUM62 with the composition bias, the reference and the
    program's plain version (ops/sw.py) give the same end and start
    points and scores."""
    import torch
    from spacedust_tpu_torch.ops.sw import sw_jobs_ref
    rng = np.random.default_rng(3)
    sub, p = scoring.blosum62()
    qs = [rng.integers(0, 20, n) for n in rng.integers(20, 200, 24)]
    ts = [np.concatenate([q[5:], rng.integers(0, 20, 30)]) for q in qs]
    qb = [scoring.comp_bias(q, sub, p).astype(np.int64) for q in qs]
    ref = align(Pairs(qs, qb, ts, sub), 11, 1, "cpu")
    qdata = torch.from_numpy(np.concatenate(qs).astype(np.int32))
    qbias = torch.from_numpy(np.concatenate(qb).astype(np.int32))
    tdata = torch.from_numpy(np.concatenate(ts).astype(np.int32))
    qoff = np.cumsum([0] + [len(q) for q in qs])[:-1]
    toff = np.cumsum([0] + [len(t) for t in ts])[:-1]
    jobs = np.stack([qoff, [len(q) for q in qs], toff, [len(t) for t in ts],
                     np.full(len(qs), -1)]).astype(np.int64)
    fwd = sw_jobs_ref(qdata, qbias, tdata, torch.from_numpy(sub), jobs,
                      11, 1, reverse=False).numpy()
    assert (fwd[0] == ref["score"]).all()
    assert (fwd[2] == ref["q_end"]).all() and (fwd[1] == ref["t_end"]).all()


def test_blosum62_and_bias_from_the_raw_file():
    from spacedust_tpu_torch.stats.submat import load_substitution_matrix
    from spacedust_tpu_torch.native import comp_bias_batch
    m = load_substitution_matrix()
    sub, p = scoring.blosum62()
    assert (sub == m.sub_int).all() and np.array_equal(p, m.p_back)
    seq = np.random.default_rng(0).integers(0, 20, 300).astype(np.uint8)
    prog = comp_bias_batch(seq, np.array([0], np.int64),
                           np.array([300], np.int32), m.sub_int, m.p_back)
    assert np.array_equal(scoring.comp_bias(seq.astype(np.int64), sub, p),
                          prog)


def test_struct_tables_match_the_program():
    from spacedust_tpu_torch.search.structure import combined_matrices
    m3, aa, gumbel = combined_matrices()
    r3, _p3, raa, lam = scoring.struct_tables()
    assert (m3 == r3).all() and (aa == raa).all()
    assert lam == gumbel.lam


def test_int8_control_saturates():
    q = np.arange(20).repeat(3)
    exact = _one(q, q, _sub(match=5), 11, 1)
    sat = _one(q, q, _sub(match=5), 11, 1, saturate=8)
    assert exact[0] == 300 and sat[0] == 127 and sat != exact


def _mutate(rng, s, ident):
    s = s.copy()
    m = rng.random(len(s)) > ident
    s[m] = rng.integers(0, 20, int(m.sum()))
    out = []
    for c in s:
        r = rng.random()
        if r < 0.03:
            continue
        out.append(c)
        if r > 0.97:
            out.extend(rng.integers(0, 20, rng.integers(1, 6)))
    return np.array(out, dtype=np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_traceback_against_the_programs(seed):
    """The plain banded traceback and the program's native one give the
    same ops and identities on homologous pairs (indels, flanks, 20-95 %
    identity) in the rectangles of the reference's SW."""
    from portbench.reference.traceback import cigar, traceback
    from spacedust_tpu_torch.native import banded_align_batch
    rng = np.random.default_rng(seed)
    sub, p = scoring.blosum62()
    qs, ts = [], []
    for _ in range(60):
        a = rng.integers(0, 20, int(rng.integers(20, 300)))
        b = _mutate(rng, a, rng.uniform(0.2, 0.95))
        if rng.random() < 0.3:
            b = np.concatenate([rng.integers(0, 20, rng.integers(0, 150)), b,
                                rng.integers(0, 20, rng.integers(0, 150))])
        qs.append(a)
        ts.append(b)
    qb = [scoring.comp_bias(q, sub, p).astype(np.int64) for q in qs]
    res = align(Pairs(qs, qb, ts, sub), 11, 1, "cpu")
    live = np.nonzero(res["score"] > 0)[0]
    rect = {k: res[k][live] for k in
            ("q_start", "q_end", "t_start", "t_end", "score")}
    ops, ids = traceback([qs[i] for i in live], [qb[i] for i in live],
                         [ts[i] for i in live], sub, rect, 11, 1, "cpu")

    def flat(seqs, dtype):
        lens = [len(seqs[i]) for i in live]
        return (np.concatenate([seqs[i] for i in live]).astype(dtype),
                np.cumsum([0] + lens)[:-1].astype(np.int64))
    qd, qo = flat(qs, np.uint8)
    td, to = flat(ts, np.uint8)
    bias, _ = flat(qb, np.int8)
    n = np.arange(len(live))
    pops, pids, pcig = banded_align_batch(
        qd, qo, td, to, bias, sub.astype(np.int8), n, n, rect["q_start"],
        rect["q_end"], rect["t_start"], rect["t_end"], rect["score"], 11, 1)
    assert ops == pops
    assert list(ids) == list(pids)
    assert [cigar(o) for o in ops] == pcig


def test_traceback_hand_case():
    from portbench.reference.traceback import cigar, traceback
    sub = _sub(match=5, mismatch=-4)
    q = np.array([0, 1, 2, 3, 4, 5, 6, 7])
    t = np.array([0, 1, 2, 3, 9, 4, 5, 6, 7])
    rect = {"q_start": np.array([0]), "q_end": np.array([7]),
            "t_start": np.array([0]), "t_end": np.array([8]),
            "score": np.array([29])}
    ops, ids = traceback([q], [np.zeros(8, np.int64)], [t], sub, rect, 11, 1,
                         "cpu")
    # 8 matches (40) with one gap of 1 (11) = 29: M4 D1 M4
    assert cigar(ops[0]) == "4M1D4M" and ids[0] == 8


def test_evalues_and_identity_text():
    from spacedust_tpu_torch.search.structure import combined_matrices
    from spacedust_tpu_torch.stats.evalue import (BLOSUM62_GAPPED_11_1,
                                                  EvalueComputation)
    from spacedust_tpu_torch.stats.fmt import fmt_double_3e, fmt_seq_id
    from portbench.reference.judge import evalue_as_printed
    raw = np.arange(20, 3000, 7)
    ql = np.random.default_rng(0).integers(30, 3000, len(raw))
    for kind, g in (("seq", BLOSUM62_GAPPED_11_1),
                    ("struct", combined_matrices()[2])):
        prog = EvalueComputation(1_700_000, g).compute_evalue(raw, ql)
        ref = scoring.evalues(raw, ql, 1_700_000, kind)
        assert all(evalue_as_printed(fmt_double_3e(p), r)
                   for p, r in zip(prog, ref))
    for ident, n in ((5, 5), (0, 7), (1, 150), (1, 1001), (333, 1000),
                     (99, 1000), (3, 4)):
        assert scoring.seq_id_text(ident, n) == fmt_seq_id(
            np.float32(ident) / np.float32(n))


def test_hits_not_best_and_evalue_rounding():
    from portbench.reference import judge
    assert judge.evalue_as_printed("1.235E-10", 1.2349e-10)
    assert not judge.evalue_as_printed("1.235E-10", 1.2344e-10)
    assert judge.evalue_as_printed("0.000E+00", 0.0)

    class Two:
        first_b = 10

        def genome(self, k):
            return int(k >= 10)
    rec = {(1, 11): None, (1, 12): None, (2, 13): None, (1, 1): None}
    cols = {(1, 11): ("", 1e-20), (1, 12): ("", 3e-30), (2, 13): ("", 1e-5)}
    hits = [(0, 1, 11, []), (0, 2, 13, [])]
    assert judge.hits_not_best(rec, hits, Two(), cols) == 1
    assert judge.hits_not_best(rec, [(0, 1, 12, []), (0, 2, 13, [])],
                               Two(), cols) == 0
