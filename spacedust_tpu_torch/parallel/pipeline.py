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

The concurrent target split (`sequential=False`, the port of the JAX
package's multi-chip pipeline) builds the shard indexes side by side and
generates each query's k-mer beam once, screened against the OR of the
shards' occupancy bitmaps and partitioned by the shards whose bitmaps hold
its k-mers, then probes every shard with its part of the beam.

The target-sharded search (`ShardedAlignmentEngine`, `sharded_search`,
`sharded_cluster_search`) runs that prefilter and aligns on a list of
devices, each shard's target tokens resident on its own device
(parallel/sw_sharded.py, ROADMAP B8): the per-pair SW and the per-target
prefilter state machine are split-invariant, so an n-shard search gives
the single engine's records and TSV.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import X_INDEX
from ..db.setdb import SetDB
from ..native import (build_shard_mask_table, partition_beams,
                      prefilter_generate_beams, prefilter_match_beams)
from ..search.alignment import AlignmentEngine, AlignmentParams
from ..search.prefilter import PrefilterEngine, PrefilterHit
from .merge import merge_shard_hits
from .split import residue_balanced_splits
from .sw_sharded import ShardedAlignDB, make_mesh


def _cat(parts: list) -> np.ndarray:
    return np.concatenate(parts) if parts else np.empty(0, np.int64)


def sharded_prefilter(query_db: SetDB, target_db: SetDB,
                      shards: list[tuple[int, int]],
                      sensitivity: float = 5.7, max_seqs: int = 300,
                      min_diag_score: int = 15,
                      comp_bias_correction: bool = True, mask: bool = True,
                      cov_thr: float = 0.0, cov_mode: int = 0,
                      same_qt_db: bool = False,
                      sequential: bool = False,
                      query_chunk: int = 8192,
                      qrange: tuple[int, int] | None = None
                      ) -> dict[int, list[PrefilterHit]]:
    """Target-split prefilter over the contiguous key ranges `shards` of
    target_db.

    `sequential=True` is the out-of-core mode (--split-memory-limit):
    shards one at a time, one engine (one shard index) in memory at a
    time.  Per-shard and merge wall seconds land in
    sharded_prefilter.last_stats (`shard_s`, a list, and `merge_s`).

    `sequential=False` is the concurrent split, with the per-query k-mer
    beam cached across shards (the reference regenerates it for every
    split, Prefiltering.cpp:662-723):
      1. each shard builds its index over a zero-copy view of its keys,
         in a thread pool;
      2. the shards' k-mer occupancy bitmaps are OR-ed into a global
         occupancy mask, and a table of shard bits a k-mer is built (8
         shards a group);
      3. the beam is generated once a query, in chunks of `query_chunk`
         queries, screened against the global mask and partitioned by
         shard;
      4. every shard is probed with its part of the beam, concurrently;
      5. the per-query shard hit lists merge under the global histogram
         re-threshold, then identity slot, --max-seqs and coverage in
         single-index order (merge_shard_hits).
    `qrange`: only the queries [lo, hi) (the keys of the result).  Wall
    seconds land in sharded_prefilter.last_stats: `index_s` and `probe_s`
    (lists, a shard each), `bitmap_or_s`, `beam_s` and `merge_s`."""
    if not sequential:
        return _sharded_prefilter_concurrent(
            query_db, target_db, shards, sensitivity=sensitivity,
            max_seqs=max_seqs, min_diag_score=min_diag_score,
            comp_bias_correction=comp_bias_correction, mask=mask,
            cov_thr=cov_thr, cov_mode=cov_mode, same_qt_db=same_qt_db,
            query_chunk=query_chunk, qrange=qrange)
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
    out = merge_shard_hits(
        _cat(acc_qk), _cat(acc_seq), _cat(acc_score), _cat(acc_diag),
        _cat(acc_arr), 0, nq, query_db.lengths, target_db.lengths, max_seqs,
        min_diag_score, cov_thr, cov_mode, same_qt_db)
    sharded_prefilter.last_stats = {"shard_s": shard_s,
                                    "merge_s": time.perf_counter() - t0}
    return out


def _sharded_prefilter_concurrent(query_db: SetDB, target_db: SetDB,
                                  shards: list[tuple[int, int]],
                                  sensitivity: float, max_seqs: int,
                                  min_diag_score: int,
                                  comp_bias_correction: bool, mask: bool,
                                  cov_thr: float, cov_mode: int,
                                  same_qt_db: bool, query_chunk: int,
                                  qrange: tuple[int, int] | None
                                  ) -> dict[int, list[PrefilterHit]]:
    """sharded_prefilter(sequential=False): see there."""
    n_sh = len(shards)
    width = max(1, min(n_sh, (os.cpu_count() or 2) // 2))

    # 1. the shards' engines (index builds, side by side)
    def build(bounds):
        t0 = time.perf_counter()
        eng = PrefilterEngine(query_db, target_db.subrange(*bounds),
                              sensitivity=sensitivity, max_seqs=max_seqs,
                              min_diag_score=min_diag_score,
                              same_qt_db=False,
                              comp_bias_correction=comp_bias_correction,
                              mask=mask, cov_thr=0.0, cov_mode=0)
        return eng, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=width) as pool:
        built = list(pool.map(build, shards))
    engines = [b[0] for b in built]
    e0 = engines[0]

    # 2. the global occupancy mask and the shard-bit tables
    t0 = time.perf_counter()
    bitmaps = np.ascontiguousarray(
        np.stack([eng.index.occupied for eng in engines]))
    gbm = np.bitwise_or.reduce(bitmaps, axis=0)
    mask_tables = [build_shard_mask_table(
        np.ascontiguousarray(bitmaps[g:g + 8])) for g in range(0, n_sh, 8)]
    bitmap_or_s = time.perf_counter() - t0

    # 3 + 4. chunked beams, concurrent shard probes
    qoffs_all = query_db.offsets
    q_lo, q_hi = qrange if qrange is not None else (0, query_db.size)
    beam_s = 0.0
    probe_s = [0.0] * n_sh
    seed_sub = np.ascontiguousarray(e0.seed.sub_int, dtype=np.int32)
    p_back = np.ascontiguousarray(e0.seed.p_back, dtype=np.float64)
    ungapped_sub = np.ascontiguousarray(e0.ungapped.sub_int, dtype=np.int32)
    sc3 = np.ascontiguousarray(e0.tables.scores, dtype=np.int16)
    id3 = np.ascontiguousarray(e0.tables.idx, dtype=np.int16)
    t2 = e0.tables2
    sc2, id2 = ((np.ascontiguousarray(t2.scores, dtype=np.int16),
                 np.ascontiguousarray(t2.idx, dtype=np.int16))
                if t2 is not None else (None, None))
    acc = [[] for _ in range(5)]      # qk, global seq, score, diag, arrival
    j_range = np.arange(max_seqs)
    for cs in range(q_lo, q_hi, query_chunk):
        ce = min(cs + query_chunk, q_hi)
        qdata = np.ascontiguousarray(
            query_db.seq_data[qoffs_all[cs]:qoffs_all[ce]], dtype=np.uint8)
        qoffs = np.ascontiguousarray(qoffs_all[cs:ce] - qoffs_all[cs],
                                     dtype=np.int64)
        qlens = np.ascontiguousarray(query_db.lengths[cs:ce],
                                     dtype=np.int32)
        ncq = ce - cs
        t0 = time.perf_counter()
        beam_kmer, beam_win, beam_offs, corr8 = prefilter_generate_beams(
            qdata, qoffs, qlens, seed_sub, p_back, comp_bias_correction,
            sc3, id3, gbm, X_INDEX, e0.kmer_thr, want_corr8=True,
            kmer_size=e0.kmer_size, sc2=sc2, id2=id2, pattern=e0.pattern)
        # a shard sees only the beam k-mers its bitmap can match
        parts = [(g, *partition_beams(beam_kmer, beam_win, beam_offs,
                                      mask_tables[gi], min(8, n_sh - g)))
                 for gi, g in enumerate(range(0, n_sh, 8))]
        del beam_kmer, beam_win
        beam_s += time.perf_counter() - t0

        def probe(si):
            eng = engines[si]
            g, pk, pw, poffs = parts[si // 8]
            li = si - g
            t0 = time.perf_counter()
            idx = eng.index
            o_seq, o_score, o_diag, o_cnt, _ = prefilter_match_beams(
                qdata, qoffs, qlens, seed_sub, p_back,
                comp_bias_correction, pk, pw,
                poffs[li * ncq:li * ncq + ncq + 1],
                idx.hkeys, idx.hoff, idx.hcnt, None,
                np.ascontiguousarray(idx.seq_ids, dtype=np.int32),
                np.ascontiguousarray(idx.positions, dtype=np.int32),
                np.ascontiguousarray(idx.t_data, dtype=np.uint8),
                np.ascontiguousarray(idx.t_offsets, dtype=np.int64),
                np.ascontiguousarray(eng._tlens, dtype=np.int32),
                ungapped_sub, max_seqs, min_diag_score, eng._bin_count,
                -1, 0.0, 0, corr8=corr8)
            dt = time.perf_counter() - t0
            # compact: (qk, global seq, score, diag, shard arrival)
            m = j_range[None, :] < o_cnt[:ncq, None]
            qi_idx, j_idx = np.nonzero(m)
            flat = qi_idx * max_seqs + j_idx
            return (si, dt, (qi_idx + cs).astype(np.int64),
                    o_seq[flat].astype(np.int64) + shards[si][0],
                    o_score[flat].astype(np.int64),
                    o_diag[flat].astype(np.int64),
                    (si * max_seqs + j_idx).astype(np.int64))

        with ThreadPoolExecutor(max_workers=width) as pool:
            for si, dt, *cols in pool.map(probe, range(n_sh)):
                probe_s[si] += dt
                for a, c in zip(acc, cols):
                    a.append(c)

    # 5. the global merge
    t0 = time.perf_counter()
    out = merge_shard_hits(
        *(_cat(a) for a in acc), q_lo, q_hi, query_db.lengths,
        target_db.lengths, max_seqs, min_diag_score, cov_thr, cov_mode,
        same_qt_db)
    sharded_prefilter.last_stats = {
        "index_s": [b[1] for b in built], "bitmap_or_s": bitmap_or_s,
        "beam_s": beam_s, "probe_s": probe_s,
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


class ShardedAlignmentEngine(AlignmentEngine):
    """AlignmentEngine whose forward and reverse stages run target-sharded
    on a list of devices (one a shard, parallel/sw_sharded.py): every
    other step, the alignment controls and the --alt-ali rounds among
    them, is the single engine's."""

    def __init__(self, query_db: SetDB, target_db: SetDB,
                 params: AlignmentParams | None, devices: list,
                 shards: list[tuple[int, int]],
                 same_qt_db: bool | None = None):
        """devices: one torch device a shard of `shards` (contiguous key
        ranges of target_db, as residue_balanced_splits gives them)."""
        if len(devices) != len(shards):
            raise ValueError(f"{len(shards)} shards for {len(devices)} "
                             "devices")
        super().__init__(query_db, target_db, params, same_qt_db=same_qt_db,
                         device=devices[0])
        self.devices = list(devices)
        self.shards = shards

    def _device_db(self) -> ShardedAlignDB:
        if self._dev is None:
            toffs = self.tdb.offsets
            self._dev = ShardedAlignDB(
                self.devices, self.qdb.seq_data, self._qbias_all(),
                self.tdb.seq_data,
                [(int(toffs[s]), int(toffs[e])) for s, e in self.shards],
                self.matrix.sub_int)
        return self._dev

    def _masked_db(self, masked: np.ndarray, moff: np.ndarray
                   ) -> ShardedAlignDB:
        """The masked copy sharded too, cut at its targets' starts."""
        return self._device_db().with_targets(masked, moff)


def sharded_search(query_db: SetDB, target_db: SetDB,
                   devices: list | None = None, n_shards: int | None = None,
                   params: AlignmentParams | None = None,
                   same_qt_db: bool | None = None,
                   sensitivity: float = 5.7, max_seqs: int = 300,
                   mask: bool = True, device: torch.device | str = "cuda",
                   metrics: dict | None = None):
    """The search stage target-sharded: the concurrent split prefilter and
    the sharded alignment over `devices` (default make_mesh(n_shards,
    device): the cards round-robin).  Returns the records of
    PrefilterEngine + AlignmentEngine.  metrics, if given, receives the
    host-clock seconds of the two steps, the prefilter's last_stats
    (`prefilter_detail`) and the sharded engine's metrics
    (`align_detail`)."""
    if devices is None:
        devices = make_mesh(n_shards, device)
    par = params or AlignmentParams()
    if same_qt_db is None:
        same_qt_db = query_db is target_db
    shards = residue_balanced_splits(target_db.lengths, len(devices))
    devices = devices[:len(shards)]
    t0 = time.perf_counter()
    hits = sharded_prefilter(
        query_db, target_db, shards, sensitivity=sensitivity,
        max_seqs=max_seqs, comp_bias_correction=par.comp_bias_correction,
        mask=mask, cov_thr=par.cov_thr, cov_mode=par.cov_mode,
        same_qt_db=same_qt_db)
    candidates = {qk: [h.seq_id for h in hs] for qk, hs in hits.items()}
    t1 = time.perf_counter()
    eng = ShardedAlignmentEngine(query_db, target_db, par, devices, shards,
                                 same_qt_db=same_qt_db)
    records = eng.align_all(candidates)
    if metrics is not None:
        metrics.update(prefilter_s=t1 - t0,
                       align_s=time.perf_counter() - t1,
                       prefilter_detail=dict(sharded_prefilter.last_stats),
                       align_detail=eng._device_db().metrics,
                       alt_detail=dict(eng.alt_metrics))
    return records


def sharded_cluster_search(query_db: SetDB, target_db: SetDB, params=None,
                           devices: list | None = None,
                           n_shards: int | None = None,
                           device: torch.device | str = "cuda"):
    """clustersearch (search mode 0) with the search stage target-sharded
    over `devices` (default make_mesh(n_shards, device)): cluster_search's
    sharded branch, with its aggregation tail.  The alignment controls of
    `params` (--max-accept, --max-rejected, --alt-ali) apply as in
    cluster_search.  timings: `search` and `aggregate` seconds and the
    search's metrics (`search_detail`, as sharded_search's `metrics`)."""
    from ..workflow.clustersearch import cluster_search
    if devices is None:
        devices = make_mesh(n_shards, device)
    return cluster_search(query_db, target_db, params, device=devices[0],
                          shard_devices=devices)
