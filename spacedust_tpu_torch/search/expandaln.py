"""expandaln: expand query->representative hits to cluster members by
backtrace composition.

Native equivalent of lib/mmseqs/src/util/expandaln.cpp:86-400 +
commons/BacktraceTranslator.h. Given an A->B alignment (query -> cluster
representative) and B->C alignments (representative -> members), infers
A->C records with the "Martins Clovis Eli" state-transition table
(BacktraceTranslator.h:24-33): both backtrace cursors always advance by
one per step, '\\0' transitions emit nothing, and the composed backtrace
is trimmed to the last match state (translateResult,
BacktraceTranslator.h:100-153).

Default expansion mode transfers score/E-value/seqId from the A->B
record (EXPAND_TRANSFER_EVALUE, expandaln.cpp:352-356); rescore mode
recomputes the substitution score over the composed backtrace
(rescoreResultByBacktrace, expandaln.cpp:27-77). A member sequence may
cover a query region only once (IntervalArray overlap check,
expandaln.cpp:327-335).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alignment import can_be_covered, has_coverage, compute_cov
from .records import AlnRecord

EXPAND_TRANSFER_EVALUE = 0
EXPAND_RESCORE_BACKTRACE = 1

# transitions[ab_state][bc_state] -> composed state ('' = emit nothing)
# (BacktraceTranslator.h:25-33: MM=M IM=I DM=D MD=D ID='' DD=D MI=I
#  II=I DI='')
_STATE = {"M": 0, "I": 1, "D": 2}      # row index: ab state
_BC_COL = {"M": 0, "D": 1, "I": 2}     # column index: bc state
_TRANS = (
    ("M", "D", "I"),   # ab = M : bc = M, D, I
    ("I", "", "I"),    # ab = I
    ("D", "D", ""),    # ab = D
)


def translate_backtrace(ab: AlnRecord, bc: AlnRecord
                        ) -> tuple[str, int, int, int, int]:
    """Compose A->B with B->C. Returns (backtrace, qStart, qEnd, tStart,
    tEnd) in A/C coordinates; empty backtrace means no inferred overlap."""
    start_b_ab = ab.tstart
    start_b_bc = bc.qstart
    dist = abs(start_b_ab - start_b_bc)

    if start_b_ab < start_b_bc:
        a_off = b_off = bt_off = 0
        while b_off < dist and bt_off < len(ab.backtrace):
            st = ab.backtrace[bt_off]
            b_off += st in "MD"
            a_off += st in "MI"
            bt_off += 1
        off_ab, off_bc = bt_off, 0
        start_a = ab.qstart + a_off
        start_c = bc.tstart
    elif start_b_ab > start_b_bc:
        b_off = c_off = bt_off = 0
        while b_off < dist and bt_off < len(bc.backtrace):
            st = bc.backtrace[bt_off]
            b_off += st in "MI"
            c_off += st in "MD"
            bt_off += 1
        off_ab, off_bc = 0, bt_off
        start_a = ab.qstart
        start_c = bc.tstart + c_off
    else:
        off_ab = off_bc = 0
        start_a = ab.qstart
        start_c = bc.tstart

    out = []
    last_m = 0
    q_aln = t_aln = 0
    i = 0
    bt_ab, bt_bc = ab.backtrace, bc.backtrace
    n_ab, n_bc = len(bt_ab), len(bt_bc)
    while off_ab < n_ab and off_bc < n_bc:
        i += 1
        t = _TRANS[_STATE[bt_ab[off_ab]]][_BC_COL[bt_bc[off_bc]]]
        if t == "":
            i -= 1
        else:
            out.append(t)
            if t == "M":
                last_m = i
                q_aln += 1
                t_aln += 1
            elif t == "D":
                q_aln += 1
            else:
                t_aln += 1
        off_ab += 1
        off_bc += 1

    bt = "".join(out)[:last_m]
    return (bt, start_a, start_a + q_aln - 1, start_c, start_c + t_aln - 1)


@dataclass
class ExpandParams:
    """expandaln is invoked with module defaults in clustersearch.sh:76
    (only threads are forwarded): -e 0.001, cov/seqId/alnLen unset."""
    eval_thr: float = 1e-3
    cov_thr: float = 0.0
    cov_mode: int = 0
    seq_id_thr: float = 0.0
    aln_len_thr: int = 0
    expansion_mode: int = EXPAND_TRANSFER_EVALUE


def expand_alignments(ab_records: dict[int, list[AlnRecord]],
                      bc_records: dict[int, list[AlnRecord]],
                      params: ExpandParams | None = None,
                      rescore=None) -> dict[int, list[AlnRecord]]:
    """ab_records: query key -> hits against representatives;
    bc_records: representative key -> hits against members (backtraced).
    `rescore(qkey, member_key, record) -> record|None` hook implements
    EXPAND_RESCORE_BACKTRACE when provided."""
    par = params or ExpandParams()
    out: dict[int, list[AlnRecord]] = {}
    for qk, hits in ab_records.items():
        results: list[AlnRecord] = []
        seen: set[int] = set()
        for ab in hits:
            if not ab.backtrace:
                raise ValueError("expandaln requires backtraces (A->B)")
            for bc in bc_records.get(ab.tkey, []):
                if not bc.backtrace:
                    raise ValueError("expandaln requires backtraces (B->C)")
                bt, qs, qe, ts, te = translate_backtrace(ab, bc)
                if len(bt) == 0:
                    continue
                if not can_be_covered(par.cov_thr, par.cov_mode,
                                      ab.qlen, bc.tlen):
                    continue
                ckey = bc.tkey
                if ckey in seen:
                    # Bug-compatible: the reference only processes a member
                    # key on first sight (expandaln.cpp:327-335 — the
                    # doesOverlap branch has no else-if, so a second
                    # non-overlapping hit is dropped too).
                    continue
                else:
                    rec = AlnRecord(
                        tkey=ckey, score=ab.score, seq_id=ab.seq_id,
                        evalue=ab.evalue, qstart=qs, qend=qe, qlen=ab.qlen,
                        tstart=ts, tend=te, tlen=bc.tlen, backtrace=bt)
                    if par.expansion_mode == EXPAND_RESCORE_BACKTRACE:
                        if rescore is None:
                            raise ValueError(
                                "rescore hook required for rescore mode")
                        rec = rescore(qk, ckey, rec)
                        if rec is None:
                            continue
                    qcov = compute_cov(rec.qstart, rec.qend, rec.qlen)
                    tcov = compute_cov(rec.tstart, rec.tend, rec.tlen)
                    ok = (has_coverage(par.cov_thr, par.cov_mode, qcov, tcov)
                          and rec.seq_id >= par.seq_id_thr - np.finfo(
                              np.float32).eps
                          and rec.evalue <= par.eval_thr
                          and len(rec.backtrace) >= par.aln_len_thr)
                    if ok:
                        results.append(rec)
                        seen.add(ckey)
        out[qk] = results
    return out
