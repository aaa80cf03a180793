"""Split prefilters: the out-of-core target split and the query split.

The target split mirrors the reference's sequential target-split mode
(Prefiltering.cpp:662-723): the target SetDB is cut into residue-balanced
contiguous shards (parallel/split.py, decomposeDomainByAminoAcid
semantics), the k-mer prefilter runs shard after shard with at most one
shard index in memory (each exactly the single-index engine's semantics,
over a zero-copy view of the shard), and the per-query shard hit lists are
merged under the global histogram re-threshold, then identity slot,
--max-seqs cap and coverage in single-index order
(Prefiltering::mergeTargetSplits, parallel/merge.py).  The per-target
prefilter state machine is split-invariant, so the split gives the records
of the unsplit search; the one caveat, shared with the reference's own
split mode, is tie ORDER inside the --max-seqs cut when a query saturates
the hit cap.

The query split (the reference's preferred split when the index fits
memory, Prefiltering.cpp:273-377) keeps one full index and prefilters
residue-balanced query slices.

The concurrent target split over several cards (shard indexes built side
by side, one cached per-query k-mer beam probed against every shard) is
not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import time

import numpy as np

from ..db.setdb import SetDB
from ..search.prefilter import PrefilterEngine, PrefilterHit
from .merge import merge_shard_hits
from .split import residue_balanced_splits


def sharded_prefilter(query_db: SetDB, target_db: SetDB,
                      shards: list[tuple[int, int]],
                      sensitivity: float = 5.7, max_seqs: int = 300,
                      min_diag_score: int = 15,
                      comp_bias_correction: bool = True, mask: bool = True,
                      cov_thr: float = 0.0, cov_mode: int = 0,
                      same_qt_db: bool = False,
                      sequential: bool = False
                      ) -> dict[int, list[PrefilterHit]]:
    """Target-split prefilter over the contiguous key ranges `shards` of
    target_db.  `sequential=True` is the out-of-core mode
    (--split-memory-limit): shards one at a time, one engine (one shard
    index) in memory at a time.  Per-shard and merge wall seconds land in
    sharded_prefilter.last_stats (`shard_s`, a list, and `merge_s`)."""
    if not sequential:
        raise NotImplementedError(
            "the concurrent target split (one shard a card) is not ported "
            "yet (ROADMAP A8)")
    acc_qk, acc_seq, acc_score, acc_diag, acc_arr = [], [], [], [], []
    shard_s = []
    nq = query_db.size
    j_range = np.arange(max_seqs)
    for si, (s, e) in enumerate(shards):
        t0 = time.perf_counter()
        shard_db = target_db.subrange(s, e)
        eng = PrefilterEngine(query_db, shard_db, sensitivity=sensitivity,
                              max_seqs=max_seqs,
                              min_diag_score=min_diag_score,
                              same_qt_db=False,
                              comp_bias_correction=comp_bias_correction,
                              mask=mask, cov_thr=0.0, cov_mode=0)
        hits = eng.match_all()
        for qk, hs in hits.items():
            n = len(hs)
            if n == 0:
                continue
            acc_qk.append(np.full(n, qk, np.int64))
            acc_seq.append(np.fromiter((h.seq_id + s for h in hs),
                                       np.int64, n))
            acc_score.append(np.fromiter((h.score for h in hs), np.int64, n))
            acc_diag.append(np.fromiter((h.diagonal for h in hs),
                                        np.int64, n))
            acc_arr.append(si * max_seqs + j_range[:n].astype(np.int64))
        del eng
        shard_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()

    def cat(parts):
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    out = merge_shard_hits(
        cat(acc_qk), cat(acc_seq), cat(acc_score), cat(acc_diag),
        cat(acc_arr), 0, nq, query_db.lengths, target_db.lengths, max_seqs,
        min_diag_score, cov_thr, cov_mode, same_qt_db)
    sharded_prefilter.last_stats = {"shard_s": shard_s,
                                    "merge_s": time.perf_counter() - t0}
    return out


def query_split_prefilter(query_db: SetDB, target_db: SetDB,
                          n_splits: int,
                          sensitivity: float = 5.7, max_seqs: int = 300,
                          comp_bias_correction: bool = True,
                          mask: bool = True, cov_thr: float = 0.0,
                          cov_mode: int = 0, same_qt_db: bool = False
                          ) -> dict[int, list[PrefilterHit]]:
    """Query-split mode: one engine holds the full target index and
    prefilters residue-balanced query slices; the merge is a
    concatenation (results are per-query complete).  Per-slice wall
    seconds land in query_split_prefilter.last_stats (`slice_s`)."""
    eng = PrefilterEngine(query_db, target_db, sensitivity=sensitivity,
                          max_seqs=max_seqs, same_qt_db=same_qt_db,
                          comp_bias_correction=comp_bias_correction,
                          mask=mask, cov_thr=cov_thr, cov_mode=cov_mode)
    out: dict[int, list[PrefilterHit]] = {}
    times = []
    for (s, e) in residue_balanced_splits(query_db.lengths, n_splits):
        t0 = time.perf_counter()
        out.update(eng.match_range(s, e))
        times.append(time.perf_counter() - t0)
    query_split_prefilter.last_stats = {"slice_s": times}
    return out
