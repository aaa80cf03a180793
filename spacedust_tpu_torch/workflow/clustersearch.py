"""The clustersearch pipeline: search -> aggregate -> cluster -> summarize.

Equivalent of the reference's clustersearch workflow
(src/workflow/clustersearch.cpp + data/clustersearch.sh) as a single
in-process pipeline with content-hash checkpointing:

  search (prefilter + align)  ->  prefixid  ->  besthitbyset
  -> mergeresultsbyset -> combinehits -> clusterhits -> summarizeresults

Workflow defaults mirror setClusterSearchWorkflowDefaults
(src/workflow/clustersearch.cpp:9-37): -s 5.7, query-cov 0.8, -e 10,
--aln-len 30, simple best hit, alpha 1.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, asdict, field
from pathlib import Path

import torch

from ..db.setdb import SetDB
from ..db.mmseqs_io import FlatDB, write_flatdb
from ..search.alignment import AlignmentEngine, AlignmentParams, COV_MODE_QUERY
from ..search.prefilter import PrefilterEngine
from ..cluster.aggregate import (besthit_by_set, merge_results_by_set,
                                 combine_hits, Match)
from ..cluster.clusterhits import cluster_hits, Cluster
from ..cluster.summarize import summarize_results, seq_to_clu
from ..utils import trace

# MMseqs2 .dbtype ids for the checkpoint DBs (Parameters.h:68-94):
# 5 = alignment result, 12 = generic/prefilter result
_DBTYPE_ALN = 5
_DBTYPE_GENERIC = 12


class StageCheckpoints:
    """Per-stage resumable artifacts in MMseqs2 flat-DB format — the
    reference's `notExists "$out"` workflow idiom (data/clustersearch.sh:
    33-165): a rerun with the same parameter hash resumes after the last
    completed stage, and every intermediate doubles as a reference-
    toolchain-readable DB (write-side interop via db/mmseqs_io.py)."""

    def __init__(self, root: Path | None):
        self.root = root
        if root is not None:
            root.mkdir(parents=True, exist_ok=True)

    def has(self, name: str) -> bool:
        return (self.root is not None
                and (self.root / f"{name}.index").exists())

    def _base(self, name: str) -> str:
        return str(self.root / name)

    def save_lines(self, name: str, data: dict[int, list[list[str]]],
                   dbtype: int = _DBTYPE_ALN) -> None:
        if self.root is None:
            return
        ents = [(qk, "".join("\t".join(c) + "\n" for c in cols))
                for qk, cols in sorted(data.items())]
        write_flatdb(self._base(name), ents, dbtype=dbtype)

    def load_lines(self, name: str) -> dict[int, list[list[str]]]:
        db = FlatDB.open(self._base(name))
        return {k: [ln.split("\t") for ln in db.lines(k)] for k in db.keys()}

    def save_matches(self, matches: list[Match]) -> None:
        if self.root is None:
            return
        write_flatdb(self._base("matches"),
                     [(i, "".join("\t".join(c) + "\n" for c in m.lines))
                      for i, m in enumerate(matches)], dbtype=_DBTYPE_ALN)
        write_flatdb(self._base("matches_h"),
                     [(i, m.header + "\n") for i, m in enumerate(matches)],
                     dbtype=_DBTYPE_GENERIC)

    def load_matches(self) -> list[Match]:
        body = FlatDB.open(self._base("matches"))
        head = FlatDB.open(self._base("matches_h"))
        out = []
        for k in head.keys():
            cols = head.get(k).strip().split("\t")
            out.append(Match(qset=int(cols[0]), tset=int(cols[1]),
                             nq=int(cols[2]), nt=int(cols[3]),
                             k=int(cols[4]), combined_eval_str=cols[5],
                             lines=[ln.split("\t") for ln in body.lines(k)]))
        return out


@dataclass
class ClusterSearchParams:
    sensitivity: float = 5.7
    max_seqs: int = 300
    cov_thr: float = 0.8
    cov_mode: int = COV_MODE_QUERY
    eval_thr: float = 10.0
    aln_len_thr: int = 30
    gap_open: int = 11
    gap_extend: int = 1
    simple_best_hit: bool = True
    # ALIGNMENT_PAR forwarding (data/clustersearch.sh; Alignment.cpp:346)
    max_accept: int = 2147483647
    max_rejected: int = 2147483647
    alt_alignments: int = 0
    subopt_hits_factor: int = 0
    alpha: float = 1.0
    aggregation_mode: int = 0
    filter_self_match: bool = False
    max_gene_gaps: int = 3
    cluster_size: int = 2
    p_clu_thr: float = 0.01
    p_mh_thr: float = 0.01
    mask: bool = True
    comp_bias_correction: bool = True
    # -k (0 = auto: IndexTable::computeKmerSize) and --spaced-kmer-mode
    kmer_size: int = 0
    spaced_kmer_mode: int = 1
    # --split-memory-limit (out-of-core target splits, the reference's
    # memory model Prefiltering.cpp:273-377,662-723): bound the per-split
    # k-mer index footprint; 0 = no splitting
    split_memory_limit: int = 0
    # --profile-cluster-search (clustersearch.cpp:29-36): search against
    # the target's cluster-representative profiles, then expand hits to
    # cluster members (expandaln); e 1e-3, 100 results.
    profile_cluster_search: bool = False
    profile_eval_thr: float = 1e-3
    profile_max_res: int = 300
    # --search-mode (LocalParameters.h:32-41): 0 = sequence, 1 = foldseek
    # on aa2foldseek-mapped subset + sequence search of the unmapped rest,
    # 2 = structure (3Di) search of the whole DB (ProstT5/foldseek-testdb
    # style, _ss states present in the SetDB)
    search_mode: int = 0


@dataclass
class ClusterSearchResult:
    tsv: str
    clusters: list[Cluster]
    matches: list[Match]
    seq_to_clu: dict[int, list[int]]
    timings: dict[str, float] = field(default_factory=dict)


def _sequence_aln_params(par: ClusterSearchParams) -> AlignmentParams:
    return AlignmentParams(gap_open=par.gap_open, gap_extend=par.gap_extend,
                           eval_thr=par.eval_thr, cov_thr=par.cov_thr,
                           cov_mode=par.cov_mode,
                           aln_len_thr=par.aln_len_thr,
                           max_accept=par.max_accept,
                           max_rejected=par.max_rejected,
                           alt_alignments=par.alt_alignments,
                           comp_bias_correction=par.comp_bias_correction)


def _structure_params(par: ClusterSearchParams):
    # FOLDSEEKSEARCH_PAR forwards only -e/-c/--cov-mode/--max-seqs
    # (LocalParameters.h foldseeksearch list); sensitivity, gap costs,
    # and aln-len stay at foldseek defaults
    from ..search.structure import StructureSearchParams
    return StructureSearchParams(
        max_seqs=par.max_seqs, eval_thr=par.eval_thr, cov_thr=par.cov_thr,
        cov_mode=par.cov_mode, mask=par.mask,
        comp_bias_correction=par.comp_bias_correction)


def cluster_search(query_db: SetDB, target_db: SetDB,
                   params: ClusterSearchParams | None = None,
                   same_qt_db: bool | None = None,
                   target_cluster_db=None,
                   query_mapping=None, target_mapping=None,
                   ckpt_dir: str | Path | None = None, *,
                   device: torch.device | str,
                   shard_devices: list | None = None) -> ClusterSearchResult:
    """clustersearch of query_db against target_db; the SW passes run on
    `device` (CUDA: the hand-written kernels; CPU: their plain PyTorch
    version).  `target_cluster_db`: a workflow.clusterdb.ClusterDB of the
    target for --profile-cluster-search (built here when absent,
    mirroring the reference's precomputed TARGET_clu_rep_profile/_clu_aln
    sidecars, data/clustersearch.sh:69-80).  `query_mapping`/
    `target_mapping`: workflow.aa2foldseek.FoldseekMapping artifacts
    (required for --search-mode 1, the reference's *_foldseek/_unmapped
    sidecars).  `shard_devices`: one torch device a target shard; the
    sequence search stage then runs target-sharded over them
    (parallel/pipeline.py::sharded_search)."""
    par = params or ClusterSearchParams()
    if shard_devices is not None and (
            par.profile_cluster_search or par.search_mode
            or par.split_memory_limit or par.kmer_size
            or par.spaced_kmer_mode != 1):
        raise ValueError("target shards serve the sequence search (search "
                         "mode 0, no --split-memory-limit, no "
                         "--profile-cluster-search, default k-mers)")
    if same_qt_db is None:
        same_qt_db = query_db is target_db
    timings: dict[str, float] = {}
    ck = StageCheckpoints(Path(ckpt_dir) if ckpt_dir is not None else None)

    if ck.has("result"):
        records = None          # search stage resumed from checkpoint
    elif par.profile_cluster_search:
        from ..search.profilesearch import (ProfileSearchParams,
                                            search_profile_target_sliced)
        from ..search.expandaln import ExpandParams, expand_alignments
        from .clusterdb import cluster_db as build_cluster_db
        if target_cluster_db is None:
            detail = {}
            with trace.span("search.clusterdb") as sp:
                target_cluster_db = build_cluster_db(target_db, device=device,
                                                     metrics=detail)
            timings["clusterdb"] = sp.seconds
            timings["clusterdb_detail"] = detail
        # the search stage runs at the outer -e (oracle: searchtarget-
        # profile.sh with -e 10); profile_eval_thr applies at expandaln
        ppar = ProfileSearchParams(
            sensitivity=par.sensitivity, eval_thr=par.eval_thr,
            max_res_list_len=par.profile_max_res, cov_thr=par.cov_thr,
            cov_mode=par.cov_mode, aln_len_thr=par.aln_len_thr,
            gap_open=par.gap_open, gap_extend=par.gap_extend,
            mask=par.mask, comp_bias_correction=par.comp_bias_correction)
        detail = {}
        # with --split-memory-limit, memory-bounded profile-DB slices
        # (searchslicedtargetprofile.sh, Search.cpp:398)
        with trace.span("search.profile") as sp:
            profile_hits = search_profile_target_sliced(
                query_db, target_db, target_cluster_db, ppar,
                split_memory_limit=par.split_memory_limit, device=device,
                metrics=detail)
        timings["profile_search"] = sp.seconds
        timings["profile_detail"] = detail
        with trace.span("search.expandaln") as sp:
            records = expand_alignments(
                profile_hits, target_cluster_db.clu_aln,
                ExpandParams(eval_thr=par.profile_eval_thr))
        timings["expandaln"] = sp.seconds
    elif par.search_mode == 1:
        # foldseek search of the aa2foldseek-mapped subset + sequence
        # search of the unmapped genes vs the full target, concatenated
        # per query key (data/clustersearch.sh:84-107)
        from ..search.structure import structure_search
        if query_mapping is None or target_mapping is None:
            raise ValueError("--search-mode 1 requires aa2foldseek mappings "
                             "for query and target (see workflow.aa2foldseek)")
        detail: dict = {}
        with trace.span("structure") as sp:
            q_att = query_mapping.attach(query_db)
            t_att = (q_att if (same_qt_db and target_mapping is query_mapping)
                     else target_mapping.attach(target_db))
            fs_records = structure_search(q_att, t_att,
                                          _structure_params(par),
                                          same_qt_db=same_qt_db,
                                          device=device, metrics=detail)
            mapped = set(query_mapping.mapping)
            records = {qk: v for qk, v in fs_records.items() if qk in mapped}
        timings["structure_search"] = sp.seconds
        timings["align_detail"] = detail

        with trace.span("search.unmapped") as sp:
            unmapped = query_mapping.unmapped_keys(query_db)
            if unmapped:
                pref = PrefilterEngine(
                    query_db, target_db, sensitivity=par.sensitivity,
                    max_seqs=par.max_seqs, same_qt_db=same_qt_db,
                    comp_bias_correction=par.comp_bias_correction,
                    mask=par.mask, cov_thr=par.cov_thr,
                    cov_mode=par.cov_mode)
                cands = {qk: [h.seq_id for h in hits] for qk, hits
                         in pref.match_all(list(unmapped)).items()}
                eng = AlignmentEngine(query_db, target_db,
                                      _sequence_aln_params(par),
                                      same_qt_db=same_qt_db, device=device)
                records.update(eng.align_all(cands))
                timings["unmapped_align_detail"] = dict(
                    eng._device_db().metrics)
        timings["unmapped_search"] = sp.seconds
    elif par.search_mode == 2:
        from ..search.structure import structure_search
        detail = {}
        with trace.span("structure") as sp:
            records = structure_search(query_db, target_db,
                                       _structure_params(par),
                                       same_qt_db=same_qt_db, device=device,
                                       metrics=detail)
        timings["structure_search"] = sp.seconds
        timings["align_detail"] = detail
    elif shard_devices is not None:
        # target-sharded: the concurrent split prefilter, then the SW of
        # each target shard on its device
        from ..parallel.pipeline import sharded_search
        detail = {}
        with trace.span("search.sharded") as sp:
            records = sharded_search(query_db, target_db,
                                     devices=shard_devices,
                                     params=_sequence_aln_params(par),
                                     same_qt_db=same_qt_db,
                                     sensitivity=par.sensitivity,
                                     max_seqs=par.max_seqs, mask=par.mask,
                                     metrics=detail)
        timings["search"] = sp.seconds
        timings["search_detail"] = detail
    elif par.split_memory_limit > 0:
        # out-of-core: sequential residue-balanced target splits bounded
        # by the memory budget; per-split hit lists are merged with the
        # global re-threshold (parallel/pipeline.sharded_prefilter), then
        # one alignment pass over the merged candidates
        from ..parallel.pipeline import sharded_prefilter
        from ..parallel.split import splits_for_memory_budget
        with trace.span("prefilter.split") as sp:
            shards = splits_for_memory_budget(target_db.lengths,
                                              par.split_memory_limit)
            hits = sharded_prefilter(
                query_db, target_db, shards, sensitivity=par.sensitivity,
                max_seqs=par.max_seqs,
                comp_bias_correction=par.comp_bias_correction, mask=par.mask,
                cov_thr=par.cov_thr, cov_mode=par.cov_mode,
                same_qt_db=same_qt_db, sequential=True)
            candidates = {qk: [h.seq_id for h in hs]
                          for qk, hs in hits.items()}
        timings["prefilter"] = sp.seconds
        timings["split_detail"] = {"shards": len(shards),
                                   **sharded_prefilter.last_stats}

        with trace.span("align") as sp:
            aln = AlignmentEngine(query_db, target_db,
                                  _sequence_aln_params(par),
                                  same_qt_db=same_qt_db, device=device)
            records = aln.align_all(candidates)
        timings["align"] = sp.seconds
        timings["align_detail"] = dict(aln._device_db().metrics)
    else:
        aln = AlignmentEngine(query_db, target_db, _sequence_aln_params(par),
                              same_qt_db=same_qt_db, device=device)

        with trace.span("prefilter.index_build") as sp:
            pref = PrefilterEngine(
                query_db, target_db, sensitivity=par.sensitivity,
                max_seqs=par.max_seqs, same_qt_db=same_qt_db,
                comp_bias_correction=par.comp_bias_correction,
                mask=par.mask, cov_thr=par.cov_thr, cov_mode=par.cov_mode,
                kmer_size=par.kmer_size or None,
                spaced_kmer_mode=par.spaced_kmer_mode)
        timings["index"] = sp.seconds

        # streamed search: the prefilter runs in contiguous query chunks
        # and each chunk's forward SW pairs go to the device engine,
        # which dispatches asynchronously as its buffer fills — device
        # scoring overlaps the host prefilter.  The NEXT chunk's native
        # prefilter (OpenMP, GIL-free) runs on a background thread while
        # the main thread does this chunk's Python-side stage0/enqueue
        # work; "prefilter" reports the EXPOSED wait time (the
        # `prefilter.wait` spans), "align" the rest of the `align` span.
        from concurrent.futures import ThreadPoolExecutor
        with trace.span("align") as sp:
            stream = aln.stream()
            chunk = max(256, (query_db.size + 7) // 8)
            ranges = [(s, min(s + chunk, query_db.size))
                      for s in range(0, query_db.size, chunk)]
            pref_s = 0.0
            with ThreadPoolExecutor(max_workers=1) as pool:
                fut = pool.submit(pref.match_range, *ranges[0])
                for i in range(len(ranges)):
                    with trace.span("prefilter.wait",
                                    chunk=ranges[i][0]) as wait:
                        hits = fut.result()
                    pref_s += wait.seconds
                    if i + 1 < len(ranges):
                        fut = pool.submit(pref.match_range, *ranges[i + 1])
                    stream.add({qk: [h.seq_id for h in hs]
                                for qk, hs in hits.items()})
            stats = getattr(pref, "stats", None)
            if stats:
                from ..utils import log
                log.info(
                    f"{stats['db_matches_per_seq']} DB matches per sequence; "
                    f"{stats['passed_per_seq']:.1f} sequences passed "
                    f"prefiltering per query ({stats['median_result_list']} "
                    f"median, {stats['empty_lists']} empty)")

            with trace.span("align.finish"):
                records = stream.finish()
        timings["prefilter"] = pref_s
        timings["align"] = sp.seconds - pref_s
        timings["align_detail"] = dict(aln._device_db().metrics)

    # prefixid: records -> prefixed column lines, then the tail
    with trace.span("cluster") as sp:
        if records is None:
            results = {qk: [[str(qk)] + c for c in cols]
                       for qk, cols in ck.load_lines("result").items()}
        else:
            # format each record's columns ONCE; the checkpoint save
            # reuses the formatted lists (string formatting dominates this
            # step on large runs)
            with trace.span("cluster.format"):
                results = {qk: [[str(qk)] + r.columns() for r in recs]
                           for qk, recs in records.items()}
            with trace.span("cluster.checkpoint"):
                ck.save_lines("result", {qk: [c[1:] for c in cols]
                                         for qk, cols in results.items()})
        matches, clusters, tsv = aggregate_results(results, query_db,
                                                   target_db, par, ck)
    timings["aggregate"] = sp.seconds

    return ClusterSearchResult(tsv=tsv, clusters=clusters, matches=matches,
                               seq_to_clu=seq_to_clu(clusters),
                               timings=timings)


def aggregate_results(results: dict[int, list[list[str]]],
                      query_db: SetDB, target_db: SetDB,
                      par: ClusterSearchParams,
                      ck: StageCheckpoints | None = None
                      ) -> tuple[list[Match], list[Cluster], str]:
    """The aggregation tail on the search results (query key -> prefixed
    column lists): besthitbyset -> mergeresultsbyset -> combinehits ->
    clusterhits -> summarizeresults, resuming from and saving to the
    checkpoints `ck`.  Returns (matches, clusters, TSV)."""
    ck = StageCheckpoints(None) if ck is None else ck
    if ck.has("matches"):
        matches = ck.load_matches()
    else:
        if ck.has("aggregate_merged"):
            merged = ck.load_lines("aggregate_merged")
        else:
            with trace.span("cluster.besthit"):
                agg = besthit_by_set(
                    results, target_db, simple_best_hit=par.simple_best_hit,
                    subopt_hits_factor=par.subopt_hits_factor)
            with trace.span("cluster.checkpoint"):
                ck.save_lines("aggregate", agg)
            with trace.span("cluster.merge"):
                merged = merge_results_by_set(agg, query_db)
            with trace.span("cluster.checkpoint"):
                ck.save_lines("aggregate_merged", merged)
        with trace.span("cluster.combine"):
            matches = combine_hits(merged, query_db, target_db,
                                   alpha=par.alpha,
                                   aggregation_mode=par.aggregation_mode,
                                   filter_self_match=par.filter_self_match)
        with trace.span("cluster.checkpoint"):
            ck.save_matches(matches)
    with trace.span("cluster.clusterhits"):
        clusters = cluster_hits(matches, query_db, target_db,
                                max_gene_gaps=par.max_gene_gaps,
                                cluster_size=par.cluster_size,
                                p_clu_thr=par.p_clu_thr,
                                p_mh_thr=par.p_mh_thr,
                                alpha=par.alpha)
    with trace.span("cluster.summarize"):
        tsv = summarize_results(clusters, query_db, target_db)
    return matches, clusters, tsv


def cluster_search_to_file(query_db: SetDB, target_db: SetDB, out_path: str,
                           tmp_dir: str | None = None, **kwargs) -> ClusterSearchResult:
    """File-level entry with parameter-hash checkpoint resume (mirrors the
    reference's notExists/tmp-hash idiom, clustersearch.cpp:73-83)."""
    params = kwargs.get("params") or ClusterSearchParams()
    res = None
    if tmp_dir is not None:
        h = hashlib.sha1(json.dumps(asdict(params), sort_keys=True).encode()
                         ).hexdigest()[:16]
        stage_dir = Path(tmp_dir) / h
        ckpt = stage_dir / "result.tsv"
        if ckpt.exists():
            tsv = ckpt.read_text()
            res = ClusterSearchResult(tsv=tsv, clusters=[], matches=[],
                                      seq_to_clu={})
        else:
            kwargs.setdefault("ckpt_dir", stage_dir)
    if res is None:
        res = cluster_search(query_db, target_db, **kwargs)
        if tmp_dir is not None:
            with trace.span("clustersearch.write_tsv"):
                ckpt.parent.mkdir(parents=True, exist_ok=True)
                ckpt.write_text(res.tsv)
    with trace.span("clustersearch.write_tsv"):
        Path(out_path).write_text(res.tsv)
    return res
