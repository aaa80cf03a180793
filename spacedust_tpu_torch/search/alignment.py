"""Alignment stage: candidates -> filtered, sorted alignment records.

Drives the device SW engine (ops/sw_engine.py) and the native banded
traceback (native/) to reproduce the reference's Alignment::run /
Matcher::getSWResult semantics (lib/mmseqs/src/alignment/
Alignment.cpp:248-540, Matcher.cpp:60-142):

  * canBeCovered length pre-check (Util.cpp:477-494)
  * identity fast path for self-hits (scoreIdentical,
    StripedSmithWaterman.cpp:1675-1710): score accumulates in int16
  * forward SW -> (score, qEnd, tEnd); E-value from raw score + full
    query length; early rejections for E-value/end-based coverage are
    output-equivalent to the reference's in-kernel returns
  * reverse SW -> (qStart, tStart) via terminate-column semantics
  * banded traceback -> CIGAR; seqId = identical/alnLen (SEQ_ID_ALN_LEN)
  * checkCriteria, then the per-query accept / reject state machine of
    --max-accept / --max-rejected in prefilter order
  * --alt-ali: alternative alignments against X-masked copies of the
    accepted targets (computeAlternativeAlignment), in rounds on the
    device
  * Matcher::compareHits sort (eval asc, bit score desc, tLen asc,
    tKey asc)

Every pair goes through the engine, at any length: there is no length
cap and no separate host SW path.  A subclass may replace the scoring
through three hooks (the structure search, search/structure.py, does):
`_device_db` (the resident engine), `evaluer` (the E-value statistics),
and the optional per-key `_identity_record` / per-pair `_traceback`,
which, when set, take the place of the batched identity and traceback
paths of the sequence search.

Profile queries (`query_profiles`, the target-profile search of
search/profilesearch.py) are scored per position from their (L, 21) int8
alignment profiles with no composition bias: the SW passes run on the
profile kernels (ops/sw_engine.py::ProfileDeviceDB), the traceback is one
banded profile alignment per pair, and identities are counted against the
profile's stored query residues (`query_profile_seqs`).  The identity
record of a profile query scores the query's residues against its own
profile rows, accumulated in int16 (scoreIdentical over a profile).

`forward_accepts` is the SCORE_ONLY acceptance pass of the iterative
search's first round (Alignment.cpp:47-56): one forward stage on the
device, records with end points only.  The engine scores with any
substitution matrix it is given (`matrix`, with its own composition bias):
the iterative search realigns with the score-bias -0.2 matrix.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import X_INDEX
from ..db.setdb import SetDB
from ..native import (banded_align_batch, banded_align_profile,
                      comp_bias_batch)
from ..ops.sw import PROF_COLS
from ..ops.sw_engine import DeviceAlignDB, ProfileDeviceDB
from ..stats.evalue import EvalueComputation, BLOSUM62_GAPPED_11_1
from ..stats.submat import SubstitutionMatrix, load_substitution_matrix
from .records import AlnRecord

COV_MODE_BIDIRECTIONAL = 0
COV_MODE_QUERY = 2
COV_MODE_TARGET = 1
_INT_MAX = 2147483647


def can_be_covered(cov_thr: float, cov_mode: int, qlen: int, tlen: int) -> bool:
    q = np.float32(qlen)
    t = np.float32(tlen)
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return bool(q / t >= thr and t / q >= thr)
    if cov_mode == COV_MODE_QUERY:
        return bool(t / q >= thr)
    if cov_mode == COV_MODE_TARGET:
        return bool(q / t >= thr)
    return True


def has_coverage(cov_thr: float, cov_mode: int, qcov: float, tcov: float) -> bool:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return bool(np.float32(qcov) >= thr and np.float32(tcov) >= thr)
    if cov_mode == COV_MODE_QUERY:
        return bool(np.float32(qcov) >= thr)
    if cov_mode == COV_MODE_TARGET:
        return bool(np.float32(tcov) >= thr)
    return True


def compute_cov(start: int, end: int, length: int) -> np.float32:
    # StripedSmithWaterman.cpp:1671-1673
    return np.float32((min(length, max(start, end)) - min(start, end) + 1)
                      / np.float32(length))


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The concatenated index ranges [starts[k], starts[k] + lens[k])."""
    lens = np.asarray(lens, dtype=np.int64)
    first = np.cumsum(lens) - lens
    return (np.repeat(np.asarray(starts, dtype=np.int64) - first, lens)
            + np.arange(int(lens.sum()), dtype=np.int64))


def _cov_vec(start: np.ndarray, end: np.ndarray, length: np.ndarray
             ) -> np.ndarray:
    # StripedSmithWaterman.cpp:1671-1673
    return ((np.minimum(length, np.maximum(start, end))
             - np.minimum(start, end) + 1).astype(np.float32)
            / length.astype(np.float32))


def _can_be_covered_vec(cov_thr: float, cov_mode: int, qlen: np.ndarray,
                        tlen: np.ndarray) -> np.ndarray:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return (qlen / tlen >= thr) & (tlen / qlen >= thr)
    if cov_mode == COV_MODE_QUERY:
        return tlen / qlen >= thr
    if cov_mode == COV_MODE_TARGET:
        return qlen / tlen >= thr
    return np.ones(len(qlen), dtype=bool)


def _has_coverage_vec(cov_thr: float, cov_mode: int, qcov: np.ndarray,
                      tcov: np.ndarray) -> np.ndarray:
    thr = np.float32(cov_thr)
    if cov_mode == COV_MODE_BIDIRECTIONAL:
        return (qcov >= thr) & (tcov >= thr)
    if cov_mode == COV_MODE_QUERY:
        return qcov >= thr
    if cov_mode == COV_MODE_TARGET:
        return tcov >= thr
    return np.ones(len(qcov), dtype=bool)


@dataclass
class AlignmentParams:
    gap_open: int = 11
    gap_extend: int = 1
    eval_thr: float = 0.001
    cov_thr: float = 0.0
    cov_mode: int = 0
    seq_id_thr: float = 0.0
    aln_len_thr: int = 0
    max_accept: int = _INT_MAX
    max_rejected: int = _INT_MAX
    alt_alignments: int = 0
    comp_bias_correction: bool = True
    include_identity: bool = False


class AlignmentEngine:
    # optional hooks (None: the batched sequence-search paths):
    #   _identity_record(qk) -> AlnRecord of the self hit;
    #   _traceback(qk, tk, q_start, q_end, t_start, t_end, score) -> ops
    _identity_record = None
    _traceback = None

    def __init__(self, query_db: SetDB, target_db: SetDB,
                 params: AlignmentParams | None = None,
                 matrix: SubstitutionMatrix | None = None,
                 same_qt_db: bool | None = None,
                 query_profiles: dict[int, np.ndarray] | None = None,
                 query_profile_seqs: dict[int, np.ndarray] | None = None, *,
                 device: torch.device | str):
        """`device` is where the SW passes run: a CUDA device launches
        the kernels of ops/sw_cuda.py, the CPU runs their plain version.

        `query_profiles` maps query keys to (L, 21) int8 alignment
        profiles (the reference's profile_for_alignment = pssm/4 with the
        X column zeroed, Sequence.cpp:271-280), L the query's length;
        every query of such an engine must have one.  They are scored per
        position (PROFILE_SEQ) with no composition bias.
        `query_profile_seqs` optionally carries each profile's stored
        query-residue column (Sequence.cpp:254, possibly tantan-masked at
        profile build time): identity counting uses it, not the gene."""
        self.qdb = query_db
        self.tdb = target_db
        self.par = params or AlignmentParams()
        self.device = torch.device(device)
        self.matrix = matrix or load_substitution_matrix()
        self.evaluer = EvalueComputation(target_db.total_residues,
                                         BLOSUM62_GAPPED_11_1)
        self.same_qt_db = (same_qt_db if same_qt_db is not None
                           else query_db is target_db)
        self._qbias_arr: np.ndarray | None = None
        self._ident_raws: np.ndarray | None = None
        self._dev: DeviceAlignDB | None = None
        self.query_profiles = query_profiles or {}
        self.query_profile_seqs = query_profile_seqs or {}
        if self.query_profiles:
            self._traceback = self._profile_traceback
            self._prof_t: dict[int, np.ndarray] = {}
        # what the --alt-ali rounds did: chains in each round, their
        # host-clock seconds, and the masked-target engines' metrics
        # summed over the rounds
        self.alt_metrics: dict = {"round_pairs": [], "rounds_s": 0.0}

    # ------------------------------------------------------------------
    def _qbias_all(self) -> np.ndarray:
        """Whole-DB int8 composition bias (zeros when the correction is
        off), computed once natively, concatenated in seq_data layout."""
        if self._qbias_arr is None:
            qdb = self.qdb
            if self.par.comp_bias_correction:
                self._qbias_arr = comp_bias_batch(
                    np.ascontiguousarray(qdb.seq_data, dtype=np.uint8),
                    np.ascontiguousarray(qdb.offsets[:-1], dtype=np.int64),
                    np.ascontiguousarray(qdb.lengths, dtype=np.int32),
                    np.ascontiguousarray(self.matrix.sub_int,
                                         dtype=np.int32),
                    np.ascontiguousarray(self.matrix.p_back,
                                         dtype=np.float64))
            else:
                self._qbias_arr = np.zeros(len(qdb.seq_data), dtype=np.int8)
        return self._qbias_arr

    def _identity_raws_all(self) -> np.ndarray:
        """Whole-DB int16 identity raw scores (scoreIdentical semantics)
        in one pass over the concatenated tokens."""
        if self._ident_raws is None:
            qdb = self.qdb
            diag = np.diagonal(self.matrix.sub_int).astype(np.int64).copy()
            d = (diag[qdb.seq_data.astype(np.int64)]
                 + self._qbias_all().astype(np.int64))
            csum = np.concatenate(([0], np.cumsum(d)))
            o = qdb.offsets
            self._ident_raws = (csum[o[1:]] - csum[o[:-1]]).astype(np.int16)
        return self._ident_raws

    def _profile_identity_raws(self, keys: np.ndarray) -> np.ndarray:
        """int16 identity raw scores of profile queries: the sum over i of
        profile[i, seq[i]] (profile_word_linear scoring of scoreIdentical),
        wrapped to int16; as int64."""
        raws = np.empty(len(keys), dtype=np.int64)
        for i, qk in enumerate(keys.tolist()):
            seq = self.qdb.sequence(qk).astype(np.int64)
            qp = self.query_profiles[qk]
            raws[i] = qp[np.arange(len(seq)), seq].astype(np.int64).sum()
        return raws.astype(np.int16).astype(np.int64)

    def _identity_records_batch(self, qkeys: np.ndarray
                                ) -> dict[int, AlnRecord]:
        """Vectorized identity fast path (scoreIdentical semantics; int16
        raw accumulation is order-independent mod 2^16)."""
        out: dict[int, AlnRecord] = {}
        if len(qkeys) == 0:
            return out
        if self._identity_record is not None:
            return {int(qk): self._identity_record(int(qk)) for qk in qkeys}
        keys = np.asarray(qkeys, dtype=np.int64)
        if self.query_profiles:
            raws = self._profile_identity_raws(keys)
        else:
            raws = self._identity_raws_all()[keys].astype(np.int64)
        lens = self.qdb.lengths[keys].astype(np.int64)
        evalues = self.evaluer.compute_evalue(raws, lens)
        bits = (self.evaluer.compute_bit_score(raws) + 0.5).astype(np.int64)
        for i, qk in enumerate(keys.tolist()):
            L = int(lens[i])
            out[qk] = AlnRecord(
                tkey=qk, score=int(bits[i]), seq_id=1.0,
                evalue=float(evalues[i]), qstart=0, qend=L - 1, qlen=L,
                tstart=0, tend=L - 1, tlen=L, backtrace="M" * L,
                raw_score=int(raws[i]), qcov=1.0, tcov=1.0,
                cigar=f"{L}M")
        return out

    # ------------------------------------------------------------------
    def forward_accepts(self, candidates: dict[int, list[int]],
                        eval_thr: float, aln_len_thr: int,
                        can_cov_thr: float, cov_mode: int
                        ) -> dict[int, list[AlnRecord]]:
        """SCORE_ONLY acceptance pass (the realign mode's first stage,
        Alignment.cpp:47-56): the length pre-check at `can_cov_thr`, the
        identity hits of a same-DB search, then one forward stage on the
        device for the other pairs.  A pair is accepted on its E-value and
        the alignment-length proxy max(q_end, t_end) + 2 (computeAlnLength
        with start -1); its record carries the end points, start -1 and no
        backtrace.  Records sorted as compareHits."""
        qks = list(candidates)
        n = sum(len(v) for v in candidates.values())
        aqk = np.fromiter((qk for qk in qks for _ in candidates[qk]),
                          np.int64, n)
        atk = np.fromiter((tk for qk in qks for tk in candidates[qk]),
                          np.int64, n)
        qlens_all, tlens_all = self.qdb.lengths, self.tdb.lengths
        covered = _can_be_covered_vec(can_cov_thr, cov_mode,
                                      qlens_all[aqk].astype(np.float32),
                                      tlens_all[atk].astype(np.float32))
        is_ident = (aqk == atk) & self.same_qt_db
        ident = np.nonzero(covered & is_ident)[0]
        ident_recs = self._identity_records_batch(np.unique(aqk[ident]))
        accepted: dict[int, list[AlnRecord]] = {qk: [] for qk in qks}
        for qk in aqk[ident].tolist():
            accepted[qk].append(ident_recs[qk])
        pairs = np.nonzero(covered & ~is_ident)[0]
        pqk, ptk = aqk[pairs], atk[pairs]
        k = len(pairs)
        score = np.zeros(k, np.int64)
        q_end = np.zeros(k, np.int64)
        t_end = np.full(k, -1, np.int64)
        if k:
            jobs = self._forward_jobs_arrays(pqk, ptk,
                                             np.arange(k, dtype=np.int64))
            for pos, (s, te, qe, _f, _fj, _fi) in self._device_db(
                    ).run_buckets(jobs, self.par.gap_open,
                                  self.par.gap_extend, reverse=False):
                score[pos], t_end[pos], q_end[pos] = s, te, qe
        qlen = qlens_all[pqk].astype(np.int64)
        evalue = self.evaluer.compute_evalue(score, qlen)
        bits = (self.evaluer.compute_bit_score(score) + 0.5).astype(np.int64)
        keep = ((t_end >= 0) & (evalue <= eval_thr)
                & (np.maximum(q_end + 1, t_end + 1) + 1 >= aln_len_thr))
        for i in np.nonzero(keep)[0].tolist():
            qk, tk = int(pqk[i]), int(ptk[i])
            accepted[qk].append(AlnRecord(
                tkey=tk, score=int(bits[i]), seq_id=0.0,
                evalue=float(evalue[i]), qstart=-1, qend=int(q_end[i]),
                qlen=int(qlen[i]), tstart=-1, tend=int(t_end[i]),
                tlen=int(tlens_all[tk]), backtrace="",
                raw_score=int(score[i])))
        for qk in accepted:
            accepted[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen,
                                             r.tkey))
        return accepted

    # ------------------------------------------------------------------
    def stream(self) -> "_AlignStream":
        """Streaming entry: add() candidate fragments as the prefilter
        produces them (forward SW dispatches asynchronously as the
        engine's buffer fills, overlapping device scoring with the host
        prefilter), finish() collects and completes.  align_all == one
        add + finish."""
        return _AlignStream(self)

    def align_all(self, candidates: dict[int, list[int]]
                  ) -> dict[int, list[AlnRecord]]:
        """candidates: query key -> target keys (prefilter order).
        Returns query key -> sorted accepted records."""
        st = self.stream()
        st.add(candidates)
        return st.finish()

    def _stage0_arrays(self, candidates: dict[int, list[int]]):
        """Array form of the identity/coverage pre-check for one
        candidate fragment.  Returns (qks, aqk, atk, keep_ident,
        pair_idx, ident_recs) where pair_idx are the candidate positions
        that become device pairs."""
        par = self.par
        qlens_all = self.qdb.lengths
        tlens_all = self.tdb.lengths
        qks = list(candidates)
        all_qk: list[int] = []
        all_tk: list[int] = []
        for qk, tkeys in candidates.items():
            all_qk.extend([qk] * len(tkeys))
            all_tk.extend(tkeys)
        aqk = np.asarray(all_qk, dtype=np.int64)
        atk = np.asarray(all_tk, dtype=np.int64)
        covered = _can_be_covered_vec(par.cov_thr, par.cov_mode,
                                      qlens_all[aqk].astype(np.float32),
                                      tlens_all[atk].astype(np.float32))
        is_ident = ((aqk == atk)
                    if (par.include_identity or self.same_qt_db)
                    else np.zeros(len(aqk), dtype=bool))
        ident_recs = self._identity_records_batch(
            np.unique(aqk[is_ident & covered]))
        keep_ident = is_ident & covered
        pair_idx = np.nonzero(covered & ~is_ident)[0]
        return qks, aqk, atk, keep_ident, pair_idx, ident_recs

    def _survivor_filter_arrays(self, pqk, ptk, scores, q_ends, t_ends):
        """Stage 2: E-value / end-coverage filters (vectorized) ->
        survivor tuples (qk, tk, score, q_end, t_end, evalue) + {pair
        idx: survivor idx} (the reverse-pass batch)."""
        par = self.par
        n = len(pqk)
        qlens = self.qdb.lengths[pqk].astype(np.int64)
        tlens = self.tdb.lengths[ptk].astype(np.int64)
        evalues = self.evaluer.compute_evalue(scores, qlens)
        qcov0 = _cov_vec(np.zeros(n, np.int64), q_ends, qlens)
        tcov0 = _cov_vec(np.zeros(n, np.int64), t_ends, tlens)
        keep = ((t_ends >= 0) & (evalues <= par.eval_thr)
                & _has_coverage_vec(par.cov_thr, par.cov_mode,
                                    qcov0, tcov0))
        surv_of_pair: dict[int, int] = {}
        survivors: list[tuple[int, int, int, int, int, float]] = []
        for pi in np.nonzero(keep)[0]:
            surv_of_pair[int(pi)] = len(survivors)
            survivors.append((int(pqk[pi]), int(ptk[pi]),
                              int(scores[pi]), int(q_ends[pi]),
                              int(t_ends[pi]), float(evalues[pi])))
        return survivors, surv_of_pair

    # ------------------------------------------------------------------
    def _device_db(self) -> DeviceAlignDB:
        """Device-resident token/bias arrays (profile rows for profile
        queries), built on first use."""
        if self._dev is None:
            if self.query_profiles:
                self._dev = ProfileDeviceDB(self._profile_rows(),
                                            self.tdb.seq_data,
                                            device=self.device)
            else:
                self._dev = DeviceAlignDB(
                    self.qdb.seq_data, self._qbias_all(), self.tdb.seq_data,
                    self.matrix.sub_int, device=self.device)
        return self._dev

    def _masked_db(self, masked: np.ndarray, moff: np.ndarray):
        """The device engine of an --alt-ali round: the resident queries
        against `masked`, the masked copy of the chains' targets (moff:
        their start offsets in it)."""
        return self._device_db().with_targets(masked)

    def _profile_rows(self) -> np.ndarray:
        """The query profiles as one (n, 21) int8 array, row k for query
        element k (zero for queries without a profile)."""
        qdb = self.qdb
        rows = np.zeros((len(qdb.seq_data), PROF_COLS), dtype=np.int8)
        for qk, prof in self.query_profiles.items():
            L = int(qdb.lengths[qk])
            if prof.shape != (L, PROF_COLS):
                raise ValueError(f"query {qk}: profile of shape {prof.shape}"
                                 f", need ({L}, {PROF_COLS})")
            o = int(qdb.offsets[qk])
            rows[o:o + L] = prof
        return rows

    def _forward_jobs_arrays(self, qk: np.ndarray, tk: np.ndarray,
                             positions: np.ndarray):
        """Forward jobs for pair arrays: element offsets, lengths,
        terminate -1 (unused), global pair positions."""
        if self.query_profiles and not all(
                int(k) in self.query_profiles for k in np.unique(qk)):
            raise ValueError("every query of a profile engine needs a "
                             "profile")
        ql = self.qdb.lengths[qk]
        return [(self.qdb.offsets[qk], ql, self.tdb.offsets[tk],
                 self.tdb.lengths[tk], np.full(len(qk), -1, np.int64),
                 positions)]

    def _reverse_jobs(self, survivors, toffs: np.ndarray | None = None):
        """Reverse jobs for survivors: reversed prefixes [0..q_end] x
        [0..t_end], terminate = forward score; positions are survivor
        indices.  toffs: each survivor's target offset where the targets
        are not the resident ones."""
        n = len(survivors)
        qk = np.fromiter((s[0] for s in survivors), np.int64, n)
        tk = np.fromiter((s[1] for s in survivors), np.int64, n)
        term = np.fromiter((s[2] for s in survivors), np.int64, n)
        ql = np.fromiter((s[3] + 1 for s in survivors), np.int64, n)
        tl = np.fromiter((s[4] + 1 for s in survivors), np.int64, n)
        return [(self.qdb.offsets[qk], ql,
                 self.tdb.offsets[tk] if toffs is None else toffs, tl, term,
                 np.arange(n, dtype=np.int64))]

    @staticmethod
    def _decode_reverse(collected, survivors, out, strict: bool = True
                        ) -> None:
        """Start points (q_start, t_start) into out.  A pair whose
        terminate score was not found raises, or with strict=False keeps
        its None."""
        for pos, (_s, _gj, _gi, found, fj, fi) in collected:
            for bi, sidx in enumerate(pos):
                if not found[bi]:
                    if not strict:
                        continue
                    raise RuntimeError(
                        "forward/backward SW scores differ for "
                        f"q={survivors[sidx][0]} t={survivors[sidx][1]}")
                q_end, t_end = survivors[sidx][3], survivors[sidx][4]
                out[sidx] = (q_end - int(fi[bi]), t_end - int(fj[bi]))

    # ------------------------------------------------------------------
    def _profile_traceback(self, qk: int, tk: int, q_start: int, q_end: int,
                           t_start: int, t_end: int, score: int) -> str:
        """Banded traceback of a profile query over its (21, L) profile."""
        prof_t = self._prof_t.get(qk)
        if prof_t is None:
            prof_t = np.ascontiguousarray(self.query_profiles[qk].T,
                                          dtype=np.int8)
            self._prof_t = {qk: prof_t}       # pairs come query by query
        return banded_align_profile(
            self.tdb.sequence(tk)[t_start:t_end + 1], q_end - q_start + 1,
            prof_t, q_start, score, self.par.gap_open, self.par.gap_extend)

    def _pair_tracebacks(self, qk, tk, q_start, q_end, t_start, t_end,
                         score):
        """Per-pair `_traceback` calls: (ops list, identity counts), where
        an identity is an M column with equal amino acids (for a profile
        query, between the profile's stored query residues and the
        target)."""
        ops_list, idents = [], []
        for i in range(len(qk)):
            ops = self._traceback(int(qk[i]), int(tk[i]), int(q_start[i]),
                                  int(q_end[i]), int(t_start[i]),
                                  int(t_end[i]), int(score[i]))
            b = np.frombuffer(ops.encode(), dtype=np.uint8)
            is_m = b == ord("M")
            q_adv = is_m | (b == ord("I"))
            t_adv = is_m | (b == ord("D"))
            qp = q_start[i] + np.cumsum(q_adv) - q_adv
            tp = t_start[i] + np.cumsum(t_adv) - t_adv
            qseq = self.query_profile_seqs.get(int(qk[i]))
            if qseq is None:
                qseq = self.qdb.sequence(int(qk[i]))
            tseq = self.tdb.sequence(int(tk[i]))
            ops_list.append(ops)
            idents.append(int((qseq[qp[is_m]] == tseq[tp[is_m]]).sum()))
        return ops_list, idents

    def _finish_pairs(self, survivors, starts, targets: tuple | None = None
                      ) -> list["AlnRecord | None"]:
        """Stage 3: vectorized coverage gate and one batched native
        traceback call for all survivors (OpenMP over pairs), or one
        `_traceback` call per pair when the hook is set.  targets:
        (tdata, toffs, rows) to trace against the token array tdata, where
        survivor i's target starts at toffs[rows[i]], instead of the
        resident targets; such records carry no precompressed CIGAR."""
        n = len(survivors)
        if n == 0:
            return []
        par = self.par
        qk = np.fromiter((s[0] for s in survivors), np.int64, n)
        tk = np.fromiter((s[1] for s in survivors), np.int64, n)
        score = np.fromiter((s[2] for s in survivors), np.int64, n)
        q_end = np.fromiter((s[3] for s in survivors), np.int64, n)
        t_end = np.fromiter((s[4] for s in survivors), np.int64, n)
        evalue = np.fromiter((s[5] for s in survivors), np.float64, n)
        q_start = np.fromiter((p[0] for p in starts), np.int64, n)
        t_start = np.fromiter((p[1] for p in starts), np.int64, n)
        qlen = self.qdb.lengths[qk].astype(np.int64)
        tlen = self.tdb.lengths[tk].astype(np.int64)
        qcov = _cov_vec(q_start, q_end, qlen)
        tcov = _cov_vec(t_start, t_end, tlen)
        cov_ok = _has_coverage_vec(par.cov_thr, par.cov_mode, qcov, tcov)
        sel = np.nonzero(cov_ok)[0]
        recs: list[AlnRecord | None] = [None] * n
        if len(sel) == 0:
            return recs
        if self._traceback is not None:
            ops_list, idents = self._pair_tracebacks(
                qk[sel], tk[sel], q_start[sel], q_end[sel], t_start[sel],
                t_end[sel], score[sel])
            cigars = [None] * len(sel)
        else:
            tdata, toffs, trow = (
                (self.tdb.seq_data, self.tdb.offsets[:-1], tk)
                if targets is None else targets)
            ops_list, idents, cigars = banded_align_batch(
                np.ascontiguousarray(self.qdb.seq_data, dtype=np.uint8),
                np.ascontiguousarray(self.qdb.offsets[:-1], dtype=np.int64),
                np.ascontiguousarray(tdata, dtype=np.uint8),
                np.ascontiguousarray(toffs, dtype=np.int64),
                np.ascontiguousarray(self._qbias_all(), dtype=np.int8),
                self.matrix.sub_int.astype(np.int8),
                qk[sel], trow[sel], q_start[sel], q_end[sel],
                t_start[sel], t_end[sel], score[sel],
                par.gap_open, par.gap_extend)
            if targets is not None:
                cigars = [None] * len(sel)
        bits = (self.evaluer.compute_bit_score(score[sel])
                + 0.5).astype(np.int64)
        for bi, si in enumerate(sel):
            ops = ops_list[bi]
            aln_len = len(ops)
            seq_id = np.float32(int(idents[bi])) / np.float32(aln_len)
            # checkCriteria (Alignment.cpp:548-567)
            if not (evalue[si] <= par.eval_thr
                    and seq_id >= np.float32(par.seq_id_thr)
                    and aln_len >= par.aln_len_thr):
                continue
            recs[si] = AlnRecord(
                tkey=int(tk[si]), score=int(bits[bi]),
                seq_id=float(seq_id), evalue=float(evalue[si]),
                qstart=int(q_start[si]), qend=int(q_end[si]),
                qlen=int(qlen[si]), tstart=int(t_start[si]),
                tend=int(t_end[si]), tlen=int(tlen[si]), backtrace=ops,
                raw_score=int(score[si]), qcov=float(qcov[si]),
                tcov=float(tcov[si]), cigar=cigars[bi])
        return recs

    # ------------------------------------------------------------------
    def _compute_alt_alignments(self, accepted: dict[int, list[AlnRecord]]
                                ) -> None:
        """computeAlternativeAlignment (Alignment.cpp:569-601): per
        accepted non-identity hit, X-mask the aligned target region
        [tstart, tend) (the end column is NOT masked: a quirk of the
        reference that is kept) and re-align up to --alt-ali times,
        masking each new hit's region too and stopping a hit's chain at
        its first failure.

        The chains of all queries advance together, a round at a time: a
        round writes the masked copies of the chains still alive into one
        token array and runs one forward stage over it, the E-value and
        end-coverage gates, one reverse stage (a terminate score that is
        not found ends the chain) and one batched traceback.  The new
        records are appended parent by parent, each parent's in round
        order, as a loop over the parents would append them: the stable
        sort that follows keeps that order among ties."""
        if self._traceback is not None:
            raise NotImplementedError(
                "--alt-ali serves the sequence search only")
        par = self.par
        t0 = time.perf_counter()
        go, ge = par.gap_open, par.gap_extend
        skip_self = par.include_identity or self.same_qt_db
        chains = [(qk, rec) for qk, out in accepted.items() for rec in out
                  if not (rec.tkey == qk and skip_self)]
        if not chains:
            return
        n = len(chains)
        cqk = np.fromiter((c[0] for c in chains), np.int64, n)
        ctk = np.fromiter((c[1].tkey for c in chains), np.int64, n)
        new: list[list[AlnRecord]] = [[] for _ in chains]
        alive = np.arange(n, dtype=np.int64)      # chain of each copy
        tlen = self.tdb.lengths[ctk].astype(np.int64)
        moff = np.cumsum(tlen) - tlen             # the copies' offsets
        masked = np.asarray(self.tdb.seq_data, dtype=np.uint8)[
            _ranges(self.tdb.offsets[ctk], tlen)]
        lo = np.fromiter((c[1].tstart for c in chains), np.int64, n)
        hi = np.fromiter((c[1].tend for c in chains), np.int64, n)
        m = self.alt_metrics
        for _round in range(par.alt_alignments):
            masked[_ranges(moff + lo, np.maximum(hi - lo, 0))] = X_INDEX
            k = len(alive)
            qk, tk = cqk[alive], ctk[alive]
            m["round_pairs"].append(k)
            dev = self._masked_db(masked, moff)
            score = np.zeros(k, np.int64)
            q_end = np.zeros(k, np.int64)
            t_end = np.full(k, -1, np.int64)
            fwd = [(self.qdb.offsets[qk], self.qdb.lengths[qk], moff, tlen,
                    np.full(k, -1, np.int64), np.arange(k, dtype=np.int64))]
            for pos, (s, te, qe, _f, _fj, _fi) in dev.run_buckets(
                    fwd, go, ge, reverse=False):
                score[pos], t_end[pos], q_end[pos] = s, te, qe
            survivors, surv_of_pair = self._survivor_filter_arrays(
                qk, tk, score, q_end, t_end)
            rows = np.fromiter(surv_of_pair, np.int64, len(survivors))
            starts: list = [None] * len(survivors)
            if survivors:
                self._decode_reverse(
                    dev.run_buckets(self._reverse_jobs(survivors, moff[rows]),
                                    go, ge, reverse=True),
                    survivors, starts, strict=False)
            found = [i for i, st in enumerate(starts) if st is not None]
            rows = rows[found]
            recs = self._finish_pairs([survivors[i] for i in found],
                                      [starts[i] for i in found],
                                      targets=(masked, moff, rows))
            for key, val in dev.metrics.items():
                if isinstance(val, (int, float)):
                    m[key] = m.get(key, 0) + val
            keep = [i for i, rec in enumerate(recs) if rec is not None]
            if not keep:
                break
            rows = rows[keep]
            for row, i in zip(rows.tolist(), keep):
                new[alive[row]].append(recs[i])
            # the chains that go on, their copies packed anew
            lo = np.fromiter((recs[i].tstart for i in keep), np.int64,
                             len(keep))
            hi = np.fromiter((recs[i].tend for i in keep), np.int64,
                             len(keep))
            masked = masked[_ranges(moff[rows], tlen[rows])]
            alive, tlen = alive[rows], tlen[rows]
            moff = np.cumsum(tlen) - tlen
        for (qk, _rec), recs in zip(chains, new):
            accepted[qk].extend(recs)
        m["rounds_s"] += time.perf_counter() - t0


class _AlignStream:
    """Incremental alignment loop: candidate fragments stream in (from
    the chunked prefilter) and their forward SW pairs are enqueued on the
    device engine, which dispatches a stage whenever its buffer fills,
    overlapping device scoring with the host prefilter of later
    fragments.  finish() flushes the rest, collects all forward results
    in one transfer, filters survivors, and runs the reverse pass and
    the traceback."""

    def __init__(self, eng: AlignmentEngine):
        self.eng = eng
        self._dev = eng._device_db()
        self._fwd_pending: list = []
        self._frags: list = []
        # pairs live as per-fragment (qk, tk) array blocks
        self._pair_qk: list[np.ndarray] = []
        self._pair_tk: list[np.ndarray] = []
        self._n_pairs = 0

    def add(self, candidates: dict[int, list[int]]) -> None:
        eng = self.eng
        qks, aqk, atk, keep_ident, pair_idx, ident_recs = \
            eng._stage0_arrays(candidates)
        base = self._n_pairs
        pair_pos = np.full(len(aqk), -1, dtype=np.int64)
        pair_pos[pair_idx] = base + np.arange(len(pair_idx))
        self._frags.append((qks, aqk, keep_ident, pair_pos, ident_recs))
        pqk, ptk = aqk[pair_idx], atk[pair_idx]
        self._pair_qk.append(pqk)
        self._pair_tk.append(ptk)
        self._n_pairs += len(pair_idx)
        if len(pair_idx):
            jobs = eng._forward_jobs_arrays(
                pqk, ptk, base + np.arange(len(pair_idx), dtype=np.int64))
            self._fwd_pending += self._dev.enqueue(
                jobs, eng.par.gap_open, eng.par.gap_extend, reverse=False)

    def _accept(self, surv_of_pair: dict[int, int],
                recs) -> dict[int, list[AlnRecord]]:
        """Accept stage.  With --max-accept / --max-rejected unset only
        kept candidates run Python, in candidate order per query.
        Otherwise every candidate steps its query's state machine in
        prefilter order, across the fragments: a query stops at
        max_accept acceptances or max_rejected consecutive rejections (an
        acceptance resets that count), where a candidate that failed the
        coverage pre-check, the survivor filter or checkCriteria is a
        rejection and an identity hit an acceptance.  Then the --alt-ali
        rounds and the compareHits sort."""
        par = self.eng.par
        limited = (par.max_accept < _INT_MAX or par.max_rejected < _INT_MAX)
        state: dict[int, list[int]] = {}     # qk -> [passed, rejected]
        surv_idx = np.full(max(self._n_pairs, 1), -1, np.int64)
        for pi, si in surv_of_pair.items():
            surv_idx[pi] = si
        recs_ok = (np.fromiter((r is not None for r in recs), bool,
                               len(recs)) if recs
                   else np.zeros(0, dtype=bool))
        accepted: dict[int, list[AlnRecord]] = {}
        for qks, aqk, keep_ident, pair_pos, ident_recs in self._frags:
            for qk in qks:
                accepted.setdefault(qk, [])
            has_pair = pair_pos >= 0
            si = np.full(len(aqk), -1, np.int64)
            si[has_pair] = surv_idx[pair_pos[has_pair]]
            ok = si >= 0
            ok[ok] = recs_ok[si[ok]]
            keep = keep_ident | ok
            for ci in (range(len(aqk)) if limited else np.nonzero(keep)[0]):
                qk = int(aqk[ci])
                if limited:
                    st = state.setdefault(qk, [0, 0])
                    if (st[0] >= par.max_accept
                            or st[1] >= par.max_rejected):
                        continue
                    if not keep[ci]:
                        st[1] += 1
                        continue
                    st[0] += 1
                    st[1] = 0
                accepted[qk].append(ident_recs[qk] if keep_ident[ci]
                                    else recs[si[ci]])
        if par.alt_alignments > 0:
            self.eng._compute_alt_alignments(accepted)
        for qk in accepted:
            accepted[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen,
                                             r.tkey))
        return accepted

    def finish(self) -> dict[int, list[AlnRecord]]:
        eng = self.eng
        go, ge = eng.par.gap_open, eng.par.gap_extend
        pqk = (np.concatenate(self._pair_qk) if self._pair_qk
               else np.empty(0, np.int64))
        ptk = (np.concatenate(self._pair_tk) if self._pair_tk
               else np.empty(0, np.int64))
        n = self._n_pairs
        self._fwd_pending += self._dev.flush(go, ge, reverse=False)
        score = np.zeros(n, np.int64)
        q_end = np.zeros(n, np.int64)
        t_end = np.full(n, -1, np.int64)
        for pos, (s, te, qe, _f, _fj, _fi) in \
                self._dev.collect(self._fwd_pending):
            score[pos] = s
            t_end[pos] = te
            q_end[pos] = qe
        survivors, surv_of_pair = eng._survivor_filter_arrays(
            pqk, ptk, score, q_end, t_end)
        starts: list = [None] * len(survivors)
        if survivors:
            eng._decode_reverse(
                self._dev.run_buckets(eng._reverse_jobs(survivors), go, ge,
                                      reverse=True),
                survivors, starts)
        recs = eng._finish_pairs(survivors, starts)
        return self._accept(surv_of_pair, recs)
