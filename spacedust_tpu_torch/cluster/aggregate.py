"""Hit aggregation: besthitbyset + mergeresultsbyset + combinehits.

Works on string-column alignment lines exactly like the reference's
Aggregation entry (src/util/Aggregation.cpp:24-157): lines are grouped
per target SET (ascending set key, std::map order), aggregated, and all
columns except the rewritten one pass through verbatim.

Input lines here are "prefixed" records: `qkey tkey score seqId eval
qStart qEnd qLen tStart tEnd tLen cigar` (prefixid semantics).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..db.setdb import SetDB
from ..stats import pvalues as pv
from ..stats.fmt import fmt_double_3e
from ..utils import trace


def _group_by_target_set(lines: list[list[str]], set_ids: np.ndarray
                         ) -> dict[int, list[list[str]]]:
    """Aggregation::buildMap — group columns by target gene's set id."""
    groups: dict[int, list[list[str]]] = {}
    for cols in lines:
        tkey = int(cols[1])
        groups.setdefault(int(set_ids[tkey]), []).append(cols)
    return dict(sorted(groups.items()))


def besthit_by_set(results: dict[int, list[list[str]]],
                   target_db: SetDB,
                   simple_best_hit: bool = True,
                   subopt_hits_factor: int = 0) -> dict[int, list[list[str]]]:
    """Per (query gene x target set): keep the best-E-value hit and rewrite
    column 2 to the log P-value (src/util/besthitbyset.cpp:41-144).

    `results[qkey]` holds prefixed column lists in result order. Returns
    the aggregated lines per query gene (already ordered by target set).
    Counts the (query gene, target set) groups as `besthit_groups`.
    """
    set_ids = target_db.set_ids
    out: dict[int, list[list[str]]] = {}
    n_groups = 0
    for qkey, lines in results.items():
        agg_lines: list[list[str]] = []
        groups = _group_by_target_set(lines, set_ids)
        n_groups += len(groups)
        for _tset, group in groups.items():
            best_eval = math.inf
            best_score = -math.inf
            second_best = -math.inf
            best_entry = None
            simple = simple_best_hit or len(group) < 2
            for cols in group:
                ev = float(cols[4])
                score = min(pv.DBL_MAX, -math.log(ev)) if ev > 0 else pv.DBL_MAX
                if simple:
                    if ev < best_eval:
                        best_eval = ev
                        best_entry = cols
                else:
                    if score >= best_score:
                        second_best = best_score
                        best_score = score
                        best_entry = cols
                    elif score > second_best:
                        second_best = score
            all_best: list[list[str]] = []
            evals: list[float] = []
            if subopt_hits_factor > 0 and simple_best_hit and len(group) > 1:
                thr = best_eval * subopt_hits_factor
                for cols in group:
                    ev = float(cols[4])
                    if ev <= thr:
                        all_best.append(cols)
                        evals.append(ev)
            else:
                all_best.append(best_entry)

            logps: list[float] = []
            if len(all_best) > 1:
                logps = [pv.compute_log_pval(e) for e in evals]
            elif simple:
                logps = [pv.compute_log_pval(best_eval)]
            else:
                logps = [second_best - best_score]

            for cols, logp in zip(all_best, logps):
                new_cols = list(cols)
                new_cols[2] = fmt_double_3e(logp)
                agg_lines.append(new_cols)
        out[qkey] = agg_lines
    trace.count("besthit_groups", n_groups)
    return out


def merge_results_by_set(agg: dict[int, list[list[str]]],
                         query_db: SetDB) -> dict[int, list[list[str]]]:
    """Concatenate member results per query set, members ascending by key
    (mergeresultsbyset over _set_to_member; createsetdb.sh:172-174 sorts
    members numerically)."""
    merged: dict[int, list[list[str]]] = {s: [] for s in range(query_db.num_sets)}
    order = np.argsort(query_db.set_ids, kind="stable")
    for qkey in order:
        qkey = int(qkey)
        if qkey in agg:
            merged[int(query_db.set_ids[qkey])].extend(agg[qkey])
    return merged


@dataclass
class Match:
    """One (query set, target set) combined-hit entry (combinehits output)."""
    qset: int
    tset: int
    nq: int
    nt: int
    k: int
    combined_eval_str: str
    lines: list[list[str]] = field(default_factory=list)

    @property
    def header(self) -> str:
        return "\t".join([str(self.qset), str(self.tset), str(self.nq),
                          str(self.nt), str(self.k), self.combined_eval_str])


AGGREGATION_MODE_MULTIHIT = 0
AGGREGATION_MODE_PRODUCT = 2
AGGREGATION_MODE_TRUNCATED_PRODUCT = 3

# combinehits.cpp:101 — hardcoded selection threshold (1e-6), NOT
# alpha/(orfCount+1); the logB tables below DO use alpha/(orfCount+1).
HARDCODED_PVAL_THRESHOLD = 10e-7


def combine_hits(merged: dict[int, list[list[str]]],
                 query_db: SetDB,
                 target_db: SetDB,
                 alpha: float = 1.0,
                 aggregation_mode: int = AGGREGATION_MODE_MULTIHIT,
                 filter_self_match: bool = False) -> list[Match]:
    """Truncated-Fisher multihit P-value per genome pair
    (src/util/combinehits.cpp:74-234). Match entries are emitted in
    (query set asc, target set asc) order with sequential keys —
    the reference's thread-local key counter makes its on-disk keys
    meaningless, so deterministic sequential order is canonical here.
    Counts the matches emitted as `combine_set_pairs`.
    """
    q_sizes = query_db.set_sizes
    t_sizes = target_db.set_sizes
    num_target_sets = target_db.num_sets
    max_orf = int(q_sizes.max()) if len(q_sizes) else 0
    lgamma = pv.make_lgamma_lookup(max_orf)

    matches: list[Match] = []
    for qset in sorted(merged.keys()):
        lines = merged[qset]
        orf_count = int(q_sizes[qset])
        log_b = pv.precompute_log_b(orf_count, alpha / (orf_count + 1), lgamma)
        for tset, group in _group_by_target_set(lines, target_db.set_ids).items():
            if filter_self_match and qset == tset:
                continue
            target_orf_count = int(t_sizes[tset])

            if aggregation_mode == AGGREGATION_MODE_MULTIHIT:
                log_thr = math.log(HARDCODED_PVAL_THRESHOLD)
                k = 0
                r = 0.0
                entries: list[list[str]] = []
                for cols in group:
                    logp = float(cols[2])
                    if logp < log_thr:
                        k += 1
                        r -= logp - log_thr
                        entries.append(cols)
                if r == 0 or k == 0:
                    continue
                if math.isinf(r):
                    eval_str = fmt_double_3e(0.0)
                else:
                    exp_minus_r = math.exp(-r)
                    if exp_minus_r == 0:
                        eval_str = fmt_double_3e(0.0)
                    else:
                        log_r = math.log(r)
                        i = np.arange(orf_count, dtype=np.float64)
                        fisher = float(np.exp(i * log_r - lgamma[1:orf_count + 1]
                                              + log_b[:orf_count]).sum())
                        eval_str = fmt_double_3e(exp_minus_r * fisher * num_target_sets)
            elif aggregation_mode == AGGREGATION_MODE_PRODUCT:
                if not group:
                    continue
                entries = list(group)
                k = len(group)
                s = sum(float(c[2]) for c in group)
                eval_str = fmt_double_3e(math.exp(s) * num_target_sets)
            elif aggregation_mode == AGGREGATION_MODE_TRUNCATED_PRODUCT:
                log_thr = math.log(alpha / (orf_count + 1))
                k = 0
                s = 0.0
                entries = []
                for cols in group:
                    logp = float(cols[2])
                    if logp < log_thr:
                        s += logp
                        k += 1
                        entries.append(cols)
                if k == 0:
                    continue
                eval_str = fmt_double_3e(math.exp(s))
            else:
                raise ValueError(f"invalid aggregation mode {aggregation_mode}")

            body = []
            for cols in entries:
                new_cols = list(cols)
                new_cols[2] = fmt_double_3e(math.exp(float(cols[2])))
                body.append(new_cols)
            matches.append(Match(qset=qset, tset=tset, nq=orf_count,
                                 nt=target_orf_count, k=k,
                                 combined_eval_str=eval_str, lines=body))
    trace.count("combine_set_pairs", len(matches))
    return matches
