"""Target-profile (exhaustive) search: query genes vs cluster profiles.

Native equivalent of the reference's exhaustive sliced target-profile
search (lib/mmseqs/src/workflow/Search.cpp:357-399 +
data/workflow/searchslicedtargetprofile.sh): the roles are inverted —
profiles run as queries against the gene DB — then results are swapped
back (swapresults, Matcher.h:93-115), recomputing each E-value from the
bit score against the profile DB's residue count.

Faithful parameter transforms (Search.cpp:365-375):
  * eval threshold scaled by #genes/#profiles for the inverted align
  * coverage mode swapped (Util::swapCoverageMode)
  * prefilter hit cap raised to max(300, #genes)
The reference's inner cluster-output align + final full align pair is
collapsed into one full align pass (identical acceptance criteria).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..db.setdb import SetDB
from ..stats.evalue import EvalueComputation, BLOSUM62_GAPPED_11_1
from ..workflow.clusterdb import ClusterDB
from .alignment import (AlignmentEngine, AlignmentParams, COV_MODE_QUERY,
                        COV_MODE_TARGET)
from .records import AlnRecord


def swap_coverage_mode(cov_mode: int) -> int:
    if cov_mode == COV_MODE_QUERY:
        return COV_MODE_TARGET
    if cov_mode == COV_MODE_TARGET:
        return COV_MODE_QUERY
    return cov_mode


def swap_record(rec: AlnRecord, qkey: int, evaluer: EvalueComputation
                ) -> AlnRecord:
    """Matcher::result_t::swapResult: exchange query/target fields, flip
    I<->D in the backtrace, recompute the E-value from the bit score with
    the swapped DB size (Matcher.h:93-115)."""
    raw = float(evaluer.compute_raw_score_from_bit_score(rec.score))
    evalue = float(evaluer.compute_evalue(raw, rec.tlen))
    bt = rec.backtrace.replace("I", "x").replace("D", "I").replace("x", "D")
    # swapresults re-parses the serialized record, so the seqId passes
    # through its printed 3-digit form (strtod of fastSeqIdToBuffer
    # output) and the final print truncates again: 0.2517 -> "0.251" ->
    # 0.250999.. -> "0.250" (swapresults.cpp record round-trip)
    from ..stats.fmt import fmt_seq_id
    seq_id = float(np.float32(float(fmt_seq_id(rec.seq_id))))
    return AlnRecord(tkey=qkey, score=rec.score, seq_id=seq_id,
                     evalue=evalue,
                     qstart=rec.tstart, qend=rec.tend, qlen=rec.tlen,
                     tstart=rec.qstart, tend=rec.qend, tlen=rec.qlen,
                     backtrace=bt, raw_score=rec.raw_score,
                     qcov=rec.tcov, tcov=rec.qcov)


@dataclass
class ProfileSearchParams:
    """clustersearch --profile-cluster-search search-stage parameters as
    actually invoked (oracle run log: searchtargetprofile.sh with -e 10,
    --max-seqs 300, query-cov 0.8, aln len 30, s 5.7; the 1e-3 threshold
    lives in expandaln and profile construction, not the search)."""
    sensitivity: float = 5.7
    eval_thr: float = 10.0
    max_res_list_len: int = 300
    cov_thr: float = 0.8
    cov_mode: int = COV_MODE_QUERY
    aln_len_thr: int = 30
    gap_open: int = 11
    gap_extend: int = 1
    mask: bool = True
    comp_bias_correction: bool = True
    # statistics overrides for searching a SUBSET of a larger profile DB
    # with the full DB's E-value semantics (oracle parity tests): the
    # eval-scale denominator (#profiles) and the swapped-search target
    # residue count (sum of ALL profile lengths)
    n_profiles_override: int | None = None
    profile_res_override: int | None = None


class TargetProfilePrefilter:
    """Gene-vs-profile-target prefilter (searchtargetprofile.sh stage 1;
    lib/mmseqs/src/prefiltering/IndexBuilder.cpp:100-140): the PROFILES
    are indexed — per profile position-window, every 6-mer whose PSSM
    score reaches the profile k-mer threshold is posted — while gene
    queries contribute only their exact spaced k-mer per window
    (takeOnlyBestKmer, Prefiltering.cpp:176-178; the bias-shifted
    query threshold is bypassed, QueryMatcher.cpp:249-253).  Diagonal
    rescoring runs the gene's blosum62+bias profile against the target
    profile's CONSENSUS residues (SequenceLookup stores
    numConsensusSequence for profiles, IndexBuilder.cpp:123-126).
    Only the k-mers of the query genes are posted (see __init__)."""

    def __init__(self, query_db: SetDB, cdb, sensitivity: float = 5.7,
                 max_seqs: int = 300, cov_thr: float = 0.8,
                 cov_mode: int = COV_MODE_QUERY,
                 comp_bias_correction: bool = True):
        from .prefilter import (SPACED_PATTERN_6, kmer_score_threshold,
                                compute_bin_count)
        self.qdb = query_db
        self.cdb = cdb
        self.max_seqs = max_seqs
        self.cov_thr = cov_thr
        self.cov_mode = cov_mode
        self.comp_bias = comp_bias_correction
        self.kmer_thr = kmer_score_threshold(sensitivity, profile=True)
        self.rep_keys = list(cdb.rep_keys)

        # --- index build: per-profile similar-k-mer postings ------------
        # natively, and only for the k-mers the query genes look up: the
        # reference posts every k-mer reaching the threshold (~600 a
        # profile position at -s 5.7, over a billion at 2 M positions);
        # match_query finds the same postings in the same order
        from ..native import profile_kmer_postings
        pssms = [cdb.pssms[r] for r in self.rep_keys]
        offs = np.concatenate(([0], np.cumsum([len(m) for m in pssms])))
        counts, km, ps = profile_kmer_postings(
            np.concatenate(pssms) if pssms else np.zeros((0, 20), np.int16),
            offs, SPACED_PATTERN_6, self.kmer_thr,
            self._query_kmer_table(query_db))
        rp = np.repeat(np.arange(len(pssms), dtype=np.int32), counts)
        # (k-mer, profile, window) order: profile after profile, each
        # profile's k-mers unique and ascending
        order = np.argsort(km, kind="stable")
        km, rp, ps = km[order], rp[order], ps[order]
        # sorted posting column; lookups binary-search it
        self.post_kmer = km
        self.post_rep = rp
        self.post_pos = ps
        # consensus residues back the diagonal rescore
        self.cons = [np.ascontiguousarray(cdb.consensus[r], dtype=np.uint8)
                     for r in self.rep_keys]
        lens = np.array([len(c) for c in self.cons], dtype=np.int64)
        self.t_offsets = np.concatenate(([0], np.cumsum(lens)))[:-1]
        self.t_data = (np.concatenate(self.cons) if len(self.cons)
                       else np.empty(0, np.uint8))
        self.t_lens = lens
        self._bin_count = compute_bin_count(len(self.rep_keys))

    @staticmethod
    def _query_kmer_table(query_db: SetDB) -> np.ndarray:
        """(20^6,) uint8: 1 for every spaced 6-mer of a query gene without
        X, the k-mers match_query looks up."""
        from ..constants import X_INDEX
        from .prefilter import KMER_SIZE, SEED_ALPHA, SPACED_PATTERN_6
        table = np.zeros(SEED_ALPHA ** KMER_SIZE, dtype=np.uint8)
        span = int(SPACED_PATTERN_6[-1]) + 1
        nwin = np.maximum(query_db.lengths.astype(np.int64) - span + 1, 0)
        first = np.cumsum(nwin) - nwin
        starts = (np.repeat(query_db.offsets[:-1].astype(np.int64) - first,
                            nwin)
                  + np.arange(int(nwin.sum()), dtype=np.int64))
        powers = SEED_ALPHA ** np.arange(KMER_SIZE, dtype=np.int64)
        packed = np.zeros(len(starts), dtype=np.int64)
        valid = np.ones(len(starts), dtype=bool)
        for p, off in enumerate(SPACED_PATTERN_6.tolist()):
            res = query_db.seq_data[starts + off]
            valid &= res != X_INDEX
            packed += res.astype(np.int64) * powers[p]
        table[packed[valid]] = 1
        return table

    def match_query(self, qk: int) -> list[int]:
        """Candidate profile reps for one gene (exact-k-mer match +
        double diagonal + consensus rescore + histogram cap), in the
        emitted prefilter order."""
        from ..constants import X_INDEX
        from .prefilter import (spaced_kmers, pack_kmers, _ragged_arange,
                                _find_double_diagonals, _per_target_max,
                                _score_threshold)
        qseq = self.qdb.sequence(qk)
        starts, kmers = spaced_kmers(qseq)
        valid = ~(kmers == X_INDEX).any(axis=1)
        starts, kmers = starts[valid], kmers[valid]
        if len(starts) == 0:
            return []
        packed = pack_kmers(kmers)
        lo = np.searchsorted(self.post_kmer, packed, side="left")
        hi = np.searchsorted(self.post_kmer, packed, side="right")
        cnt = hi - lo
        if cnt.sum() == 0:
            return []
        k_rep = np.repeat(np.arange(len(packed)), cnt)
        take = lo[k_rep] + _ragged_arange(cnt)
        seqs = self.post_rep[take]
        diags = ((starts[k_rep] - self.post_pos[take])
                 & 0xFFFF).astype(np.uint16)
        cand_seq, cand_diag, arrival = _find_double_diagonals(seqs, diags)
        scores = self._rescore(qseq, cand_seq, cand_diag)
        hits = _per_target_max(cand_seq, cand_diag, scores, arrival,
                               self._bin_count)
        thr = max(15, _score_threshold(hits, self.max_seqs))
        out = []
        order = np.argsort(-hits[:, 2].astype(np.int64), kind="stable")
        for i in order:
            if len(out) >= self.max_seqs:
                break
            if hits[i, 2] >= thr:
                out.append(int(hits[i, 0]))
        if self.cov_thr > 0.0 and self.cov_mode in (0, 2, 5):
            ql = np.float32(len(qseq))
            kept = []
            for ri in out:
                tl = np.float32(self.cdb.pssms[self.rep_keys[ri]].shape[0])
                if self.cov_mode == 0:
                    ok = ql / tl >= np.float32(self.cov_thr) \
                         and tl / ql >= np.float32(self.cov_thr)
                elif self.cov_mode == 2:
                    ok = tl / ql >= np.float32(self.cov_thr)
                else:
                    ok = (min(tl, ql) / max(tl, ql)
                          >= np.float32(self.cov_thr))
                if ok:
                    kept.append(ri)
            out = kept
        return [self.rep_keys[ri] for ri in out]

    def _rescore(self, qseq, cand_seq, cand_diag):
        """Ungapped Kadane rescore of the gene's blosum62+bias profile
        against the candidates' consensus diagonals (clamped 255)."""
        from ..stats.submat import (load_pinned_matrix,
                                    local_aa_bias_correction)
        ung = load_pinned_matrix("blosum62_bf2_bias")
        L = len(qseq)
        if self.comp_bias:
            seed = load_pinned_matrix("vtml80_bf8_bias")
            bias_f32 = local_aa_bias_correction(qseq, seed.sub_int,
                                                seed.p_back, 1.0)
        else:
            bias_f32 = np.zeros(L, dtype=np.float32)
        corr = bias_f32.astype(np.float64) / 4.0
        corr = np.where(corr < 0.0, corr - 0.5, corr + 0.5).astype(np.int8)
        profile = (ung.sub_int[qseq].astype(np.int32)
                   + corr[:, None].astype(np.int32))
        C = len(cand_seq)
        scores = np.zeros(C, dtype=np.int32)
        if C == 0:
            return scores
        d16 = cand_diag.astype(np.int64) & 0xFFFF
        min_dist = np.minimum((0 - d16) & 0xFFFF, d16)
        tl = self.t_lens[cand_seq]
        pos_diag = d16 < 0x8000
        seg = np.where(pos_diag,
                       np.where(min_dist < L, np.minimum(tl, L - min_dist), 0),
                       np.where(min_dist < tl, np.minimum(tl - min_dist, L),
                                0))
        q_off = np.where(pos_diag, min_dist, 0)
        t_off = np.where(pos_diag, 0, min_dist)
        Lmax = int(seg.max()) if len(seg) else 0
        if Lmax == 0:
            return scores
        ar = np.arange(Lmax, dtype=np.int64)
        mask = ar[None, :] < seg[:, None]
        qpos = np.minimum(q_off[:, None] + ar[None, :], L - 1)
        tpos = self.t_offsets[cand_seq][:, None] + np.minimum(
            t_off[:, None] + ar[None, :], np.maximum(tl[:, None] - 1, 0))
        t_res = self.t_data[tpos]
        vals = profile[qpos, t_res.astype(np.int64)] * mask
        c = np.cumsum(vals, axis=1)
        run_min = np.minimum.accumulate(
            np.concatenate([np.zeros((C, 1), c.dtype), c[:, :-1]], axis=1),
            axis=1)
        best = (c - np.minimum(run_min, 0)).max(axis=1)
        best = np.where(seg > 0, np.maximum(best, 0), 0)
        return np.minimum(best, 255).astype(np.int32)


def profile_slices(cdb: ClusterDB, split_memory_limit: int
                   ) -> list[list[int]]:
    """Greedy memory-bounded slices of the profile DB (the
    searchslicedtargetprofile.sh splitting, dispatched from
    workflow/Search.cpp:398: slice count from the memory model,
    Prefiltering.cpp:273-377).  The per-profile footprint estimate is
    the similar-k-mer beam index: ~rows x beam postings (12 B each) +
    the PSSM/consensus arrays — ~2 KB per profile position at the
    default profile k-mer threshold."""
    per_pos_bytes = 2048
    slices: list[list[int]] = []
    cur: list[int] = []
    used = 0
    for r in cdb.rep_keys:
        cost = int(cdb.pssms[r].shape[0]) * per_pos_bytes
        if cur and used + cost > split_memory_limit:
            slices.append(cur)
            cur, used = [], 0
        cur.append(r)
        used += cost
    if cur:
        slices.append(cur)
    return slices


def search_profile_target_sliced(query_db: SetDB, target_db: SetDB,
                                 cdb: ClusterDB,
                                 params: ProfileSearchParams | None = None,
                                 split_memory_limit: int = 0, *,
                                 device: torch.device | str,
                                 metrics: dict | None = None
                                 ) -> dict[int, list[AlnRecord]]:
    """Memory-bounded target-profile search: the profile DB is processed
    in sequential slices (searchslicedtargetprofile.sh), each slice runs
    the same two stages as the exhaustive path with E-values computed
    against the FULL profile DB's residue count, and per-query results
    are merged + re-sorted + capped globally.  With a cap that does not
    bind (the common case) the merged output equals the exhaustive
    search's; when the per-query candidate cap binds, slices can keep
    MORE candidates than one memory-bound pass — the same property the
    reference's split merge + re-threshold has (Prefiltering.cpp:356-361).
    `metrics`, if given, gets search_profile_target's metrics summed over
    the slices (`align_detail` key by key) and their count (`slices`).
    """
    import dataclasses
    par = params or ProfileSearchParams()
    if split_memory_limit <= 0:
        return search_profile_target(query_db, target_db, cdb, par,
                                     device=device, metrics=metrics)
    m = metrics if metrics is not None else {}
    n_p = len(cdb.rep_keys)
    profile_res = (int(sum(cdb.pssms[r].shape[0] for r in cdb.rep_keys))
                   + n_p // 25 - n_p)
    merged: dict[int, list[AlnRecord]] = {qk: []
                                          for qk in range(query_db.size)}
    slices = profile_slices(cdb, split_memory_limit)
    m["slices"] = len(slices)
    for sl in slices:
        sub = dataclasses.replace(cdb, rep_keys=list(sl))
        spar = dataclasses.replace(par, n_profiles_override=n_p,
                                   profile_res_override=profile_res)
        part_m: dict = {}
        part = search_profile_target(query_db, target_db, sub, spar,
                                     device=device, metrics=part_m)
        for key, val in part_m.items():
            if key == "align_detail":
                ad = m.setdefault("align_detail", {})
                for k, v in val.items():
                    ad[k] = ad.get(k, 0) + v
            else:
                m[key] = m.get(key, 0.0) + val
        for qk, recs in part.items():
            merged[qk].extend(recs)
    for qk in merged:
        merged[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen, r.tkey))
        del merged[qk][par.max_res_list_len:]
    return merged


def search_profile_target(query_db: SetDB, target_db: SetDB,
                          cdb: ClusterDB,
                          params: ProfileSearchParams | None = None, *,
                          device: torch.device | str,
                          metrics: dict | None = None
                          ) -> dict[int, list[AlnRecord]]:
    """Search query genes against the target's cluster-representative
    profiles. Returns query key -> profile hits (tkey = rep key), sorted
    by Matcher::compareHits and capped at max_res_list_len.  The SW
    passes of the profile queries run on `device`.  `metrics`, if given,
    gets the host-clock seconds of the profile index, the per-gene match,
    the swapped alignment and the swap back (`index_s`, `match_s`,
    `align_s`, `swap_s`) and the SW engine's metrics (`align_detail`)."""
    par = params or ProfileSearchParams()
    n_genes = query_db.size
    m = metrics if metrics is not None else {}
    t0 = time.perf_counter()

    # stage 1 (searchtargetprofile.sh): genes vs the profile-built index
    tpf = TargetProfilePrefilter(query_db, cdb,
                                 sensitivity=par.sensitivity,
                                 max_seqs=300, cov_thr=par.cov_thr,
                                 cov_mode=par.cov_mode,
                                 comp_bias_correction=par.comp_bias_correction)
    m["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cands: dict[int, list[int]] = {rep: [] for rep in cdb.rep_keys}
    for qk in range(n_genes):
        for rep in tpf.match_query(qk):
            cands[rep].append(qk)
    m["match_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # stage 2: swapped align — profiles as queries against the genes
    # (same -e as the outer search; coverage mode swapped)
    aln_par = AlignmentParams(gap_open=par.gap_open,
                              gap_extend=par.gap_extend,
                              eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                              cov_mode=swap_coverage_mode(par.cov_mode),
                              aln_len_thr=par.aln_len_thr,
                              comp_bias_correction=par.comp_bias_correction)
    eng = AlignmentEngine(target_db, query_db, aln_par, same_qt_db=False,
                          query_profiles=cdb.aln_profiles,
                          query_profile_seqs=getattr(cdb, "query_seqs",
                                                     None),
                          device=device)
    inv_records = eng.align_all(cands)
    m["align_s"] = time.perf_counter() - t0
    m["align_detail"] = dict(eng._device_db().metrics)
    t0 = time.perf_counter()

    # swapresults: profile-DB residue count per DBReader::
    # getAminoAcidDBSize for DBTYPE_HMM_PROFILE = dataSize/25 - size
    # (DBReader.cpp:589-597); dataSize counts each entry's NUL, so the
    # exact value is total_len + n//25 - n, not the plain length sum
    n_p = par.n_profiles_override or len(cdb.rep_keys)
    profile_res = (par.profile_res_override
                   or int(sum(cdb.pssms[r].shape[0] for r in cdb.rep_keys))
                   + n_p // 25 - n_p)
    evaluer = EvalueComputation(profile_res, BLOSUM62_GAPPED_11_1)
    swapped: dict[int, list[AlnRecord]] = {qk: [] for qk in range(n_genes)}
    for rep, recs in inv_records.items():
        for r in recs:
            swapped[r.tkey].append(swap_record(r, rep, evaluer))
    for qk in swapped:
        # swapresults re-applies -e after the E-value recomputation
        swapped[qk] = [r for r in swapped[qk] if r.evalue <= par.eval_thr]
        swapped[qk].sort(key=lambda r: (r.evalue, -r.score, r.tlen, r.tkey))
        del swapped[qk][par.max_res_list_len:]
    m["swap_s"] = time.perf_counter() - t0
    return swapped
