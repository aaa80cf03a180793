"""Agglomerative clustering of hits by gene-neighborhood conservation.

Faithful re-implementation of src/util/ClusterHits.cpp:215-510 with the
reference's exact scan order (first-maximum argmax semantics,
ClusterHits.cpp:377-402,423-451) so cluster membership matches
bit-for-bit. The K x K merge loop runs per genome-pair match, with K a
few hundred hits between two genomes and a few thousand between genomes
of one lineage; the numpy dense formulation recomputes merged-cluster
scores from member hits each iteration exactly like groupNodes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..db.setdb import SetDB
from ..stats import pvalues as pv
from ..utils import trace
from .aggregate import Match


@dataclass
class Hit:
    line: str          # full alignment line (verbatim, with trailing \n)
    pval: float
    q_pos: int
    t_pos: int
    q_strand: bool
    t_strand: bool


@dataclass
class Cluster:
    qset: int
    tset: int
    p_co: float
    p_mh: float
    hits: list[Hit] = field(default_factory=list)

    @property
    def header(self) -> str:
        from ..stats.fmt import fmt_double_3e
        return "\t".join([str(self.qset), str(self.tset),
                          fmt_double_3e(self.p_co), fmt_double_3e(self.p_mh),
                          str(len(self.hits))])


def _span(hits: list[Hit]) -> int:
    qs = [h.q_pos for h in hits]
    ts = [h.t_pos for h in hits]
    return max(max(qs) - min(qs) + 1, max(ts) - min(ts) + 1)


def _conserved_pairs(hits: list[Hit]) -> int:
    s = sorted(hits, key=lambda h: h.q_pos)
    m = 0
    for l in range(len(s) - 1):
        same_order = s[l + 1].t_pos > s[l].t_pos
        s1 = s[l].q_strand == s[l].t_strand
        s2 = s[l + 1].q_strand == s[l + 1].t_strand
        if (s1 == same_order) and (s2 == same_order):
            m += 1
    return m


def _cluster_match_score(lookup: np.ndarray, hits: list[Hit]) -> float:
    """clusterMatchScore (ClusterHits.cpp:120-134)."""
    if not hits:
        return 0.0
    span = _span(hits)
    k = len(hits)
    m = _conserved_pairs(hits)
    return (-0.5 * pv.log_cluster_pval(lookup, k, span)
            - 0.5 * pv.log_ordering_pval(lookup, k, m))


def _compatible(c1: list[Hit], c2: list[Hit], d: int) -> bool:
    """isCompatibleCluster (ClusterHits.cpp:137-159). The reference
    computes min() over UNSIGNED differences, so negative gaps wrap to
    huge values — replicate with uint arithmetic."""
    i_max1 = max(h.q_pos for h in c1); i_min1 = min(h.q_pos for h in c1)
    j_max1 = max(h.t_pos for h in c1); j_min1 = min(h.t_pos for h in c1)
    i_max2 = max(h.q_pos for h in c2); i_min2 = min(h.q_pos for h in c2)
    j_max2 = max(h.t_pos for h in c2); j_min2 = min(h.t_pos for h in c2)

    def u32(x: int) -> int:
        return x & 0xFFFFFFFF

    return (min(u32(j_min1 - j_max2), u32(j_min2 - j_max1)) <= d and
            min(u32(i_min1 - i_max2), u32(i_min2 - i_max1)) <= d)


def _group_nodes(nodes: list[list[int]], match: list[Hit], i: int, j: int,
                 d: int) -> list[Hit]:
    """groupNodes (ClusterHits.cpp:162-181)."""
    if not nodes[i] or not nodes[j]:
        return []
    c1 = [match[n] for n in nodes[i]]
    c2 = [match[n] for n in nodes[j]]
    if _compatible(c1, c2, d):
        return c1 + c2
    return []


def _merge_nodes(match: list[Hit], lookup: np.ndarray, d: int,
                 s_min: float) -> list[list[int]]:
    """The merge loop (ClusterHits.cpp:377-451) on a match's hits: the
    node lists it leaves, an emptied node as []."""
    K = len(match)
    dist = np.zeros((K, K), dtype=np.float64)
    dmin = np.zeros(K, dtype=np.int64)
    nodes: list[list[int]] = [[n] for n in range(K)]

    for i in range(K):
        for j in range(K):
            if i != j:
                tmp = _group_nodes(nodes, match, i, j, d)
                dist[i, j] = _cluster_match_score(lookup, tmp)
            # first-max scan: strict > keeps the earliest maximum
            if dist[i, j] > dist[i, dmin[i]]:
                dmin[i] = j

    max_score = math.inf
    first_iter = True
    while first_iter or max_score >= s_min:
        i1 = 0
        for i in range(K):
            if dist[i, dmin[i]] > dist[i1, dmin[i1]]:
                i1 = i
        i2 = int(dmin[i1])
        max_score = dist[i1, i2]
        if max_score != 0:
            first_iter = False
        else:
            break

        nodes[i1].extend(nodes[i2])
        nodes[i2] = []

        for j in range(K):
            if j == i1 or j == i2:
                dist[i1, j] = 0.0
                dist[j, i1] = 0.0
            else:
                tmp = _group_nodes(nodes, match, i1, j, d)
                s = _cluster_match_score(lookup, tmp)
                dist[i1, j] = s
                dist[j, i1] = s
            dist[i2, j] = 0.0
            dist[j, i2] = 0.0
            # dmin maintenance replicated verbatim (ClusterHits.cpp:438-449)
            if j != 0:
                if dist[i1, j] > dist[i1, dmin[i1]]:
                    dmin[i1] = j
            else:
                dmin[i1] = j
            if j != i1 and j != i2:
                if dist[j, i1] > dist[j, dmin[j]]:
                    dmin[j] = i1
    return nodes


def cluster_hits(matches: list[Match],
                 query_db: SetDB,
                 target_db: SetDB,
                 max_gene_gaps: int = 3,
                 cluster_size: int = 2,
                 p_clu_thr: float = 0.01,
                 p_mh_thr: float = 0.01,
                 alpha: float = 1.0,
                 use_native: bool = True) -> list[Cluster]:
    """use_native: run the merge loop in C (native/clusterhits_engine.cpp,
    OpenMP over the initial score rows, the merges serial; same scan
    order — tests assert equality with the pure-Python loop, which
    remains the executable specification).

    Each match gets a span `cluster.clusterhits.hits` round building its
    K hits and, where K >= 2, `cluster.clusterhits.merge` round the merge
    loop (attrs qset, tset, hits = K); the counts `clusterhits_pairs`
    (matches merged), `clusterhits_hits` (sum of K) and
    `clusterhits_cells` (sum of K^2 over the matches merged: the initial
    score matrices' cells)."""
    max_orf = int(max(query_db.set_sizes.max(initial=0),
                      target_db.set_sizes.max(initial=0)))
    lookup = pv.make_cluster_lgamma_lookup(max_orf)
    d = max_gene_gaps
    # thresholds are C floats (LocalParameters.h:47-48) — keep f32 rounding
    p_clu_thr = float(np.float32(p_clu_thr))
    p_mh_thr = float(np.float32(p_mh_thr))

    # merge-stop threshold (ClusterHits.cpp:394)
    s_min = (-0.5 * pv.log_cluster_pval(lookup, 2, d + 1)
             - 0.5 * pv.log_ordering_pval(lookup, 2, 1))

    out: list[Cluster] = []
    n_pairs = n_hits = n_cells = 0
    for mt in matches:
        K = len(mt.lines)
        with trace.span("cluster.clusterhits.hits", qset=mt.qset,
                        tset=mt.tset, hits=K):
            match: list[Hit] = []
            for cols in mt.lines:
                qid = int(cols[0])
                tid = int(cols[1])
                match.append(Hit(
                    line="\t".join(cols) + "\n",
                    pval=float(cols[2]),
                    q_pos=int(query_db.pos_idx[qid]),
                    t_pos=int(target_db.pos_idx[tid]),
                    q_strand=bool(query_db.starts[qid] < query_db.ends[qid]),
                    t_strand=bool(target_db.starts[tid] < target_db.ends[tid]),
                ))
        n_hits += K
        if K == 1:
            continue
        n_pairs += 1
        n_cells += K * K

        with trace.span("cluster.clusterhits.merge", qset=mt.qset,
                        tset=mt.tset, hits=K):
            if use_native:
                from ..native import cluster_hits_native
                nodes, scores = cluster_hits_native(
                    np.array([h.q_pos for h in match], dtype=np.int64),
                    np.array([h.t_pos for h in match], dtype=np.int64),
                    np.array([h.q_strand for h in match], dtype=np.uint8),
                    np.array([h.t_strand for h in match], dtype=np.uint8),
                    lookup, d, s_min)
            else:
                nodes, scores = _merge_nodes(match, lookup, d, s_min), None

        for i, node in enumerate(nodes):
            if len(node) >= cluster_size:
                cluster = [match[n] for n in node]
                score = (_cluster_match_score(lookup, cluster)
                         if scores is None else float(scores[i]))
                p_co = math.exp(-score)
                p_mh = pv.cluster_multihit_pval(
                    np.array([h.pval for h in cluster]), mt.nq, alpha, lookup)
                if p_co <= p_clu_thr and p_mh <= p_mh_thr:
                    out.append(Cluster(qset=mt.qset, tset=mt.tset,
                                       p_co=p_co, p_mh=p_mh, hits=cluster))
    trace.count("clusterhits_pairs", n_pairs)
    trace.count("clusterhits_hits", n_hits)
    trace.count("clusterhits_cells", n_cells)
    return out
