"""clusterdb: prepare a profile-search target from a SetDB.

Native equivalent of the reference's clusterdb workflow
(src/workflow/clusterdb.cpp:9-86 + data/clusterdb.sh:97-126, sequence
path): cluster the SetDB (seqId >= 0.7, bidirectional cov >= 0.8,
set-cover), then per representative
  * `_clu_rep_profile`: result2profile over the cluster members
    (alignments recomputed unfiltered, result2profile.cpp:215-232, then
    MSA-diversity-filtered) -> PSSM,
  * `_clu`: profile2consensus consensus sequence,
  * `_clu_aln`: rep->member gapped alignments with backtrace
    (align IN IN cluster -a, e <= 1e-3), consumed by expandaln in
    --profile-cluster-search mode.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..db.setdb import SetDB
from ..search.alignment import AlignmentEngine, AlignmentParams
from ..search.msafilter import filter_msa
from ..search.profile import compute_msa, compute_pssm
from ..search.records import AlnRecord, expand_cigar
from ..stats.submat import load_pinned_matrix
from ..cluster.seqcluster import SeqClusterParams, cluster_sequences


@dataclass
class ClusterDB:
    """Profile-search target artifact (the reference's *_clu_rep_profile,
    *_clu, *_clu_aln sidecar DBs)."""
    rep_keys: list[int]
    clusters: dict[int, list[int]]              # rep key -> member keys
    pssms: dict[int, np.ndarray]                # rep key -> (L, 20) int16
    aln_profiles: dict[int, np.ndarray]         # rep key -> (L, 21) int8
    consensus: dict[int, np.ndarray]            # rep key -> (L,) uint8
    clu_aln: dict[int, list[AlnRecord]]         # rep key -> member records
    # profile-stored query residues (Sequence.cpp:254; may be tantan-
    # masked at build time) — identity counting uses these, not the gene
    query_seqs: dict[int, np.ndarray] = None

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta = {
            "rep_keys": self.rep_keys,
            "clusters": {str(k): v for k, v in self.clusters.items()},
            "clu_aln": {str(k): [r.line() for r in v]
                        for k, v in self.clu_aln.items()},
        }
        (path / "clusterdb.json").write_text(json.dumps(meta))
        arrays = {}
        for k in self.rep_keys:
            arrays[f"pssm_{k}"] = self.pssms[k]
            arrays[f"alnp_{k}"] = self.aln_profiles[k]
            arrays[f"cons_{k}"] = self.consensus[k]
            if self.query_seqs:
                arrays[f"qseq_{k}"] = self.query_seqs[k]
        np.savez_compressed(path / "profiles.npz", **arrays)

    @classmethod
    def load(cls, path: str | Path) -> "ClusterDB":
        path = Path(path)
        meta = json.loads((path / "clusterdb.json").read_text())
        arrays = np.load(path / "profiles.npz")
        rep_keys = [int(k) for k in meta["rep_keys"]]
        clu_aln = {}
        for k, rows in meta["clu_aln"].items():
            recs = []
            for line in rows:
                r = AlnRecord.parse(line)
                r.backtrace = expand_cigar(r.backtrace)
                recs.append(r)
            clu_aln[int(k)] = recs
        return cls(
            rep_keys=rep_keys,
            clusters={int(k): v for k, v in meta["clusters"].items()},
            pssms={k: arrays[f"pssm_{k}"] for k in rep_keys},
            aln_profiles={k: arrays[f"alnp_{k}"] for k in rep_keys},
            consensus={k: arrays[f"cons_{k}"] for k in rep_keys},
            clu_aln=clu_aln,
            query_seqs=({k: arrays[f"qseq_{k}"] for k in rep_keys}
                        if rep_keys and f"qseq_{rep_keys[0]}" in arrays
                        else None))

    @classmethod
    def exists(cls, path: str | Path) -> bool:
        return (Path(path) / "clusterdb.json").exists()


@dataclass
class ClusterDBParams:
    cluster: SeqClusterParams = field(default_factory=SeqClusterParams)
    # result2profile defaults (Parameters.cpp): pca 1.1 pcb 4.1 handled in
    # compute_pssm; _clu_aln align: -a -e 0.001 (align module defaults)
    aln_eval_thr: float = 1e-3
    # False = the reference's default cascaded `mmseqs cluster` workflow
    # (linclust pass + sensitivity ramp, cascaded_clustering.sh); True =
    # one direct round (--single-step-clustering)
    single_step_clustering: bool = True


def cluster_db(db: SetDB, params: ClusterDBParams | None = None,
               clusters: dict[int, list[int]] | None = None, *,
               device: torch.device | str,
               metrics: dict | None = None) -> ClusterDB:
    """Cluster `db` (unless `clusters` is given) and build the profile
    target.  The SW passes run on `device`.  `metrics`, if given, gets
    the host-clock seconds of the stages: `cluster_s` (with the single
    step's `prefilter_s` / `align_s` / `cluster_align_detail`),
    `profiles_s` (the rep->member alignments and the PSSMs), and
    `clu_aln_s`."""
    par = params or ClusterDBParams()
    m = metrics if metrics is not None else {}
    t0 = time.perf_counter()
    if clusters is None:
        if par.single_step_clustering:
            detail: dict = {}
            clusters = cluster_sequences(db, par.cluster, device=device,
                                         metrics=detail)
            m.update(prefilter_s=detail["prefilter_s"],
                     align_s=detail["align_s"],
                     cluster_align_detail=detail["align_detail"])
        else:
            from ..cluster.cascade import cascaded_cluster
            clusters = cascaded_cluster(db, par.cluster, device=device)
    m["cluster_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_keys = sorted(clusters.keys())
    matrix = load_pinned_matrix("blosum62_bf2_bias")

    # rep -> member SW alignments, unfiltered (result2profile recompute
    # path: getSWResult with no E-value/coverage cutoffs)
    prof_par = AlignmentParams(eval_thr=float("inf"), cov_thr=0.0,
                               cov_mode=0, seq_id_thr=0.0, aln_len_thr=0)
    prof_eng = AlignmentEngine(db, db, prof_par, same_qt_db=True,
                               device=device)
    cands = {rep: [m for m in members if m != rep]
             for rep, members in clusters.items()}
    prof_records = prof_eng.align_all(cands)

    pssms: dict[int, np.ndarray] = {}
    aln_profiles: dict[int, np.ndarray] = {}
    consensus: dict[int, np.ndarray] = {}
    query_seqs: dict[int, np.ndarray] = {}
    for rep in rep_keys:
        q = db.sequence(rep)
        # preserve member order of the alignment records
        recs = [r for r in prof_records.get(rep, []) if r.tkey != rep]
        targets = [db.sequence(r.tkey) for r in recs]
        msa = compute_msa(q, targets, recs)
        keep = filter_msa(msa, sub_int=matrix.sub_int)
        sel = np.nonzero(keep[1:])[0]
        prof = compute_pssm(q, [targets[i] for i in sel],
                            [recs[i] for i in sel], matrix)
        pssm = prof.pssm.astype(np.int16)
        pssms[rep] = pssm
        ap = np.zeros((pssm.shape[0], 21), dtype=np.int8)
        ap[:, :20] = np.trunc(pssm.astype(np.float64) / 4).astype(np.int8)
        aln_profiles[rep] = ap
        consensus[rep] = prof.consensus
        query_seqs[rep] = prof.query

    m["profiles_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # _clu_aln: rep -> member alignments with backtrace (align -a)
    aln_par = AlignmentParams(eval_thr=par.aln_eval_thr, cov_thr=0.0,
                              cov_mode=0, include_identity=True)
    aln_eng = AlignmentEngine(db, db, aln_par, same_qt_db=True,
                              device=device)
    clu_aln = aln_eng.align_all({rep: clusters[rep] for rep in rep_keys})
    m["clu_aln_s"] = time.perf_counter() - t0

    return ClusterDB(rep_keys=rep_keys, clusters=clusters, pssms=pssms,
                     aln_profiles=aln_profiles, consensus=consensus,
                     clu_aln=clu_aln, query_seqs=query_seqs)


def clusterdb_from_reference(base: str | Path,
                             rep_subset: "set[int] | None" = None
                             ) -> ClusterDB:
    """Build a ClusterDB view from reference-toolchain clusterdb output
    (<base>_clu, <base>_clu_rep_profile, <base>_clu_aln; spacedust's
    data/clusterdb.sh).  Profile entries decode per Sequence::mapProfile
    (lib/mmseqs/src/commons/Sequence.cpp:241-274): 25 bytes/position,
    raw char scores cast to short, and the alignment profile =
    profile_score / 4 with C truncation (Sequence.cpp:274)."""
    from ..db.mmseqs_io import FlatDB
    from ..search.records import AlnRecord, expand_cigar
    base = str(base)
    clu = FlatDB.open(base + "_clu")
    clusters = {int(k): [int(x) for x in clu.lines(k)]
                for k in clu.keys()
                if rep_subset is None or int(k) in rep_subset}
    prof_db = FlatDB.open(base + "_clu_rep_profile")
    pssms: dict[int, np.ndarray] = {}
    aln_profiles: dict[int, np.ndarray] = {}
    consensus: dict[int, np.ndarray] = {}
    query_seqs: dict[int, np.ndarray] = {}
    for k in prof_db.keys():
        if rep_subset is not None and int(k) not in rep_subset:
            continue
        raw = np.frombuffer(prof_db.get_bytes(k), dtype=np.uint8)
        arr = raw[:(len(raw) // 25) * 25].reshape(-1, 25)
        pssm = arr[:, :20].copy().view(np.int8).astype(np.int16)
        pssms[int(k)] = pssm
        ap = np.zeros((len(arr), 21), dtype=np.int8)
        ap[:, :20] = np.trunc(pssm.astype(np.float64) / 4).astype(np.int8)
        aln_profiles[int(k)] = ap
        # byte 20 of each 25-byte position stores the (possibly
        # tantan-masked) query residues (Sequence.cpp PROFILE_AA_SIZE);
        # identity-parity seqId counting must use these, not the
        # unmasked gene sequence
        query_seqs[int(k)] = arr[:, 20].copy()
        consensus[int(k)] = arr[:, 21].copy()
    aln_db = FlatDB.open(base + "_clu_aln")
    clu_aln = {}
    for k in aln_db.keys():
        if rep_subset is not None and int(k) not in rep_subset:
            continue
        recs = [AlnRecord.parse(ln) for ln in aln_db.lines(k)]
        for r in recs:
            r.backtrace = expand_cigar(r.backtrace)
        clu_aln[int(k)] = recs
    return ClusterDB(rep_keys=sorted(clusters), clusters=clusters,
                     pssms=pssms, aln_profiles=aln_profiles,
                     consensus=consensus, clu_aln=clu_aln,
                     query_seqs=query_seqs)


def cluster_db_cached(db: SetDB, cache_dir: str | Path,
                      params: ClusterDBParams | None = None, *,
                      device: torch.device | str) -> ClusterDB:
    """Content-cached clusterdb (the notExists resume idiom): loads
    `cache_dir` if it holds a ClusterDB (written by either package), else
    builds one on `device` and saves it there."""
    cache_dir = Path(cache_dir)
    if ClusterDB.exists(cache_dir):
        return ClusterDB.load(cache_dir)
    cdb = cluster_db(db, params, device=device)
    cdb.save(cache_dir)
    return cdb
