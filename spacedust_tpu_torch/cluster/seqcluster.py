"""Sequence clustering: set-cover / connected-component / greedy-incremental
over an all-vs-all homology graph.

Native equivalent of the reference's clustering layer
(lib/mmseqs/src/clustering/ClusteringAlgorithms.cpp:45-260,
Clustering.cpp): the alignment result graph is symmetrized
(AlignmentSymmetry::findMissingLinks/addMissingLinks semantics: a->b
implies b->a carrying the same score), sequences are ordered descending
by length (DBReader SORT_BY_LENGTH, ties by key ascending), and the
greedy set-cover picks the largest remaining neighborhood first.

The set-cover replicates the reference's bucket-array scan order
exactly (initClustersizes/removeClustersize/decreaseClustersize,
ClusteringAlgorithms.cpp:157-215): cluster ids are laid out ascending
by current size (insertion order by internal id within a size class),
the scan walks positions from the top, and decreases only ever move ids
downward, so representative selection is bit-deterministic.

Edge scores are sequence identities scaled to unsigned short
(AlignmentSymmetry::readInData, APC_SEQID: ushort(seqId*1000);
self-edges get 1000).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..db.setdb import SetDB
from ..search.alignment import (AlignmentEngine, AlignmentParams,
                                COV_MODE_BIDIRECTIONAL)
from ..search.prefilter import PrefilterEngine
from ..search.records import AlnRecord

MODE_SET_COVER = 0          # --cluster-mode 0 (ClusteringAlgorithms mode 1)
MODE_CONNECTED_COMPONENT = 1  # --cluster-mode 1 (mode 3)
MODE_GREEDY = 2             # --cluster-mode 2 (greedyIncrementalLowMem)


def length_order(db: SetDB) -> np.ndarray:
    """Internal id order: keys sorted by length descending, key ascending
    (DBReader::sortIndex SORT_BY_LENGTH with stable id tie-break)."""
    lens = db.lengths
    keys = np.arange(db.size)
    return keys[np.lexsort((keys, -lens.astype(np.int64)))]


def build_graph(db: SetDB, records: dict[int, list[AlnRecord]]
                ) -> tuple[np.ndarray, list[list[tuple[int, int]]]]:
    """Symmetrized adjacency in internal (length-sorted) id space.

    Returns (order, adj) where order[i] = key of internal id i and
    adj[i] = [(internal_j, ushort_score), ...] in record order with
    missing reverse links appended (addMissingLinks appends at the end
    of each row, carrying the forward score)."""
    order = length_order(db)
    key_to_int = np.empty(db.size, dtype=np.int64)
    key_to_int[order] = np.arange(db.size)

    n = db.size
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    present: list[set[int]] = [set() for _ in range(n)]
    for i in range(n):
        key = int(order[i])
        for r in records.get(key, []):
            j = int(key_to_int[r.tkey])
            score = 1000 if r.tkey == key else int(
                np.float32(r.seq_id) * np.float32(1000.0))
            adj[i].append((j, score))
            present[i].add(j)
        if not records.get(key):
            # empty entry: self link with max score (readInData empty case)
            adj[i].append((i, 1000))
            present[i].add(i)
    # addMissingLinks: reverse edges appended in forward-scan order
    for i in range(n):
        for j, score in list(adj[i]):
            if i not in present[j]:
                adj[j].append((i, score))
                present[j].add(i)
    return order, adj


class _SizeBuckets:
    """sorted_clustersizes bucket array (ClusteringAlgorithms.cpp:157-215)."""

    def __init__(self, sizes: list[int]):
        n = len(sizes)
        self.sizes = list(sizes)
        maxsz = max(sizes) if sizes else 0
        abundance = [0] * (maxsz + 1)
        for s in sizes:
            abundance[s] += 1
        self.borders = [0] * (maxsz + 1)
        for s in range(1, maxsz + 1):
            self.borders[s] = self.borders[s - 1] + abundance[s - 1]
        self.sorted = [-1] * (n + 1)
        self.pos = [-1] * (n + 1)
        fill = [0] * (maxsz + 1)
        for i, s in enumerate(sizes):
            p = self.borders[s] + fill[s]
            self.sorted[p] = i
            self.pos[i] = p
            fill[s] += 1

    def remove(self, cid: int) -> None:
        self.sizes[cid] = 0
        self.sorted[self.pos[cid]] = -1
        self.pos[cid] = -1

    def decrease(self, cid: int) -> None:
        old = self.pos[cid]
        new = self.borders[self.sizes[cid]]
        swapid = self.sorted[new]
        if swapid != -1:
            self.pos[swapid] = old
        self.sorted[old] = swapid
        self.sorted[new] = cid
        self.pos[cid] = new
        self.borders[self.sizes[cid]] += 1
        self.sizes[cid] -= 1


def set_cover(adj: list[list[tuple[int, int]]]) -> np.ndarray:
    """Greedy set-cover (ClusteringAlgorithms::setCover). Returns
    assigned[i] = internal id of the representative."""
    n = len(adj)
    assigned = np.full(n, -1, dtype=np.int64)
    best = np.full(n, np.iinfo(np.int16).min, dtype=np.int64)
    buckets = _SizeBuckets([len(a) for a in adj])
    clustersizes = buckets.sizes  # shared list, mutated via buckets

    for pos in range(n - 1, -1, -1):
        rep = buckets.sorted[pos]
        if rep == -1:
            continue
        buckets.remove(rep)
        assigned[rep] = rep
        for m, score in adj[rep]:
            if score > best[m]:
                assigned[m] = rep
                best[m] = score
            if m == rep:
                continue
            if clustersizes[m] < 1:
                continue
            buckets.remove(m)
        for m, _score in adj[rep]:
            if m == rep:
                clustersizes[m] = -1
                continue
            if clustersizes[m] < 0:
                continue
            clustersizes[m] = -1
            for m2, _s2 in adj[m]:
                if clustersizes[m2] > 0:
                    buckets.decrease(m2)
    return assigned


def connected_component(adj: list[list[tuple[int, int]]],
                        max_iterations: int = 1000) -> np.ndarray:
    """BFS components seeded largest-neighborhood-first
    (ClusteringAlgorithms::execute mode 3), depth-capped at
    max_iterations."""
    n = len(adj)
    assigned = np.full(n, -1, dtype=np.int64)
    buckets = _SizeBuckets([len(a) for a in adj])
    from collections import deque
    for pos in range(n - 1, -1, -1):
        rep = buckets.sorted[pos]
        if rep == -1 or assigned[rep] != -1:
            continue
        assigned[rep] = rep
        queue = deque([(rep, 0)])
        while queue:
            cur, depth = queue.popleft()
            assigned[cur] = rep
            for m, _s in adj[cur]:
                if assigned[m] == -1 and depth < max_iterations:
                    queue.append((m, depth + 1))
                assigned[m] = rep
    return assigned


def greedy_incremental(adj: list[list[tuple[int, int]]]) -> np.ndarray:
    """Greedy incremental (CD-HIT-style) clustering in length-desc order
    (ClusteringAlgorithms::greedyIncrementalLowMem): the first unassigned
    sequence becomes a representative and absorbs its still-unassigned
    hits."""
    n = len(adj)
    assigned = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if assigned[i] == -1:
            assigned[i] = i
        rep = assigned[i]
        for m, _s in adj[i]:
            if assigned[m] == -1:
                assigned[m] = rep
    return assigned


@dataclass
class SeqClusterParams:
    """Defaults mirror setclusterDbDefaults (src/workflow/clusterdb.cpp:9-13)
    + the mmseqs cluster workflow defaults (-s 4, --max-seqs 20, -e 1e-3)."""
    seq_id_thr: float = 0.7
    cov_thr: float = 0.8
    cov_mode: int = COV_MODE_BIDIRECTIONAL
    sensitivity: float = 4.0
    max_seqs: int = 20
    eval_thr: float = 1e-3
    mode: int = MODE_SET_COVER
    mask: bool = True
    comp_bias_correction: bool = True


def cluster_sequences(db: SetDB, params: SeqClusterParams | None = None,
                      records: dict[int, list[AlnRecord]] | None = None, *,
                      device: torch.device | str,
                      metrics: dict | None = None) -> dict[int, list[int]]:
    """All-vs-all prefilter + gapped alignment + greedy clustering.
    Returns {representative key: sorted member keys} (the reference's
    cluster result DB: rep-keyed member lists, assignment pairs sorted,
    ClusteringAlgorithms.cpp:136-154).  The SW passes run on `device`;
    `metrics`, if given, gets the host-clock seconds of the prefilter and
    the alignment (`prefilter_s`, `align_s`) and the SW engine's metrics
    (`align_detail`)."""
    par = params or SeqClusterParams()
    if records is None:
        t0 = time.perf_counter()
        pref = PrefilterEngine(db, db, sensitivity=par.sensitivity,
                               max_seqs=par.max_seqs, same_qt_db=True,
                               comp_bias_correction=par.comp_bias_correction,
                               mask=par.mask,
                               cov_thr=par.cov_thr, cov_mode=par.cov_mode)
        cands = {qk: [h.seq_id for h in hits]
                 for qk, hits in pref.match_all().items()}
        aln_par = AlignmentParams(eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                                  cov_mode=par.cov_mode,
                                  seq_id_thr=par.seq_id_thr,
                                  comp_bias_correction=par.comp_bias_correction)
        eng = AlignmentEngine(db, db, aln_par, same_qt_db=True,
                              device=device)
        t1 = time.perf_counter()
        records = eng.align_all(cands)
        if metrics is not None:
            metrics.update(prefilter_s=t1 - t0,
                           align_s=time.perf_counter() - t1,
                           align_detail=dict(eng._device_db().metrics))

    order, adj = build_graph(db, records)
    if par.mode == MODE_SET_COVER:
        assigned = set_cover(adj)
    elif par.mode == MODE_CONNECTED_COMPONENT:
        assigned = connected_component(adj)
    else:
        assigned = greedy_incremental(adj)

    clusters: dict[int, list[int]] = {}
    for i in range(len(adj)):
        rep_key = int(order[assigned[i]])
        clusters.setdefault(rep_key, []).append(int(order[i]))
    return {rep: sorted(members) for rep, members in sorted(clusters.items())}
