"""Vectorized target-split merge (Prefiltering::mergeTargetSplits
semantics, lib/mmseqs/src/prefiltering/Prefiltering.cpp:379-560):
per-query shard hit lists are re-thresholded against the GLOBAL score
histogram, the identity slot is re-inserted, the --max-seqs cap applies
in (clamped score desc, shard arrival) order, and the length-coverage
filter runs last — exactly the single-index emit order of
QueryMatcher.cpp:100-210.  Whole-batch numpy.
"""

from __future__ import annotations

import numpy as np

from ..search.prefilter import PrefilterHit


def merge_shard_hits(qk: np.ndarray, seq: np.ndarray, score: np.ndarray,
                     diag: np.ndarray, arrival: np.ndarray,
                     q_lo: int, q_hi: int,
                     qlens: np.ndarray, tlens: np.ndarray, max_seqs: int,
                     min_diag_score: int, cov_thr: float, cov_mode: int,
                     same_qt_db: bool) -> dict[int, list[PrefilterHit]]:
    """Merge flat per-shard hit arrays into per-query capped hit lists
    for the query-key range [q_lo, q_hi).

    qk/seq/score/diag/arrival: parallel int64 arrays over every shard
    hit; `arrival` orders hits of one query as the shard-concatenated
    stream (shard-major, emit order within shard).
    """
    out: dict[int, list[PrefilterHit]] = {q: [] for q in range(q_lo, q_hi)}
    if same_qt_db:
        for q in range(q_lo, q_hi):
            out[q].append(PrefilterHit(seq_id=q, score=65535, diagonal=0))
    if len(qk) == 0:
        return out
    nq = q_hi - q_lo

    clamped = np.minimum(score, 255)

    # --- per-query histogram threshold (computeScoreThreshold) --------
    hist = np.zeros((nq, 256), dtype=np.int64)
    np.add.at(hist, (qk - q_lo, np.clip(clamped, 0, 255)), 1)
    # rc[q, t] = number of hits with clamped score >= t
    rc = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]
    ok = rc[:, 1:] >= max_seqs                      # columns t = 1..255
    has = ok.any(axis=1)
    # largest t with rc[t] >= max_seqs (the first hit walking 255 -> 1)
    thr = np.where(has, 255 - np.argmax(ok[:, ::-1], axis=1), 0)
    thr = np.maximum(thr, min_diag_score)

    # --- (score desc, arrival) order with the --max-seqs cap ----------
    order = np.lexsort((arrival, -clamped, qk))
    o_qk = qk[order]
    o_elig = (clamped[order] >= thr[o_qk - q_lo])
    if same_qt_db:
        o_elig &= seq[order] != o_qk
    cap = max_seqs - (1 if same_qt_db else 0)
    # rank among eligible hits within each query segment
    c = np.cumsum(o_elig.astype(np.int64))
    first = np.concatenate(([True], o_qk[1:] != o_qk[:-1]))
    base = np.zeros(len(o_qk), dtype=np.int64)
    fidx = np.nonzero(first)[0]
    base[fidx] = c[fidx] - o_elig[fidx]
    base = np.maximum.accumulate(base)
    rank = c - base - o_elig.astype(np.int64)       # eligible seen before
    keep = o_elig & (rank < cap)

    k_qk = o_qk[keep]
    k_seq = seq[order][keep]
    k_score = score[order][keep]
    k_diag = diag[order][keep]

    # --- length-coverage filter (applied AFTER the cap,
    #     Prefiltering.cpp:856-864) ------------------------------------
    if cov_thr > 0.0 and cov_mode in (0, 2, 5) and len(k_qk):
        ql = qlens[k_qk].astype(np.float32)
        tl = tlens[k_seq].astype(np.float32)
        ct = np.float32(cov_thr)
        if cov_mode == 0:
            covok = (ql / tl >= ct) & (tl / ql >= ct)
        elif cov_mode == 2:
            covok = tl / ql >= ct
        else:
            covok = (np.minimum(tl, ql) / np.maximum(tl, ql)) >= ct
        k_qk = k_qk[covok]
        k_seq = k_seq[covok]
        k_score = k_score[covok]
        k_diag = k_diag[covok]

    # --- materialize per-query lists ----------------------------------
    bounds = np.searchsorted(k_qk, np.arange(q_lo, q_hi + 1))
    for q in range(q_lo, q_hi):
        s, e = int(bounds[q - q_lo]), int(bounds[q - q_lo + 1])
        if s == e:
            continue
        lst = out[q]
        lst.extend(PrefilterHit(seq_id=int(k_seq[i]), score=int(k_score[i]),
                                diagonal=int(k_diag[i]))
                   for i in range(s, e))
    return out
