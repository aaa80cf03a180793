"""Iterative profile search (blastpgp.sh equivalent).

Round 0 searches with sequence queries and REALIGNS accepted hits with a
score-bias -0.2 matrix (Alignment.cpp:47-56,407-442); a PSSM is built per
query from the accepted alignments (result2profile); later rounds search
with profile queries, subtracting targets already aligned below the
profile E-value (subtractdbs semantics, subtractdbs.cpp:36-110), and the
per-round alignment lists are concatenated (mergedbs order: earlier
rounds first).

Thresholds follow Search.cpp:476-516: intermediate rounds run with
evalThr = min(-e, --e-profile); the final round restores the original -e.

Every SW pass runs on `device`: round 0's acceptance pass and its
realignment on the sequence kernels (the realignment with the bias
matrix), the profile rounds on the profile kernels.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..db.setdb import SetDB
from ..stats.submat import load_pinned_matrix
from .alignment import AlignmentEngine, AlignmentParams
from .msafilter import filter_msa
from .prefilter import PrefilterEngine
from .profile import compute_msa, compute_pssm
from .records import AlnRecord


def build_profiles(query_db: SetDB, target_db: SetDB,
                   records: dict[int, list[AlnRecord]],
                   eval_profile: float) -> tuple[dict, dict]:
    """result2profile over alignment records: returns
    (pssm_scores per qk (L,20) int16, alignment profiles per qk (L,21) int8)."""
    matrix = load_pinned_matrix("blosum62_bf2_bias")
    pssms = {}
    aln_profiles = {}
    for qk, recs in records.items():
        sel_recs, targets = [], []
        for r in recs:
            if r.tkey == qk:
                continue
            if r.evalue < eval_profile:
                sel_recs.append(r)
                targets.append(target_db.sequence(r.tkey))
        q = query_db.sequence(qk)
        msa = compute_msa(q, targets, sel_recs)
        keep = filter_msa(msa, sub_int=matrix.sub_int)
        sel = np.nonzero(keep[1:])[0]
        prof = compute_pssm(q, [targets[i] for i in sel],
                            [sel_recs[i] for i in sel], matrix)
        pssm = prof.pssm.astype(np.int16)           # (L, 20)
        pssms[qk] = pssm
        ap = np.zeros((pssm.shape[0], 21), dtype=np.int8)
        ap[:, :20] = np.trunc(pssm.astype(np.float64) / 4).astype(np.int8)
        aln_profiles[qk] = ap
    return pssms, aln_profiles


def subtract_candidates(cands: dict[int, list[int]],
                        prev: dict[int, list[AlnRecord]],
                        eval_thr: float) -> dict[int, list[int]]:
    out = {}
    for qk, tkeys in cands.items():
        flagged = {r.tkey for r in prev.get(qk, []) if r.evalue <= eval_thr}
        out[qk] = [t for t in tkeys if t not in flagged]
    return out


def index_bytes(index) -> int:
    """Bytes of a KmerIndex's arrays: postings, masked targets, hash."""
    return sum(getattr(index, name).nbytes for name in (
        "kmers", "seq_ids", "positions", "t_data", "hkeys", "hoff", "hcnt",
        "occupied"))


@dataclass
class IterativeSearchConfig:
    num_iterations: int = 2
    sensitivity: float = 5.7
    max_seqs: int = 300
    eval_thr: float = 10.0
    eval_profile: float = 0.001
    cov_thr: float = 0.8
    cov_mode: int = 2
    aln_len_thr: int = 30
    gap_open: int = 11
    gap_extend: int = 1
    mask: bool = True
    comp_bias_correction: bool = True


def search_iterative(query_db: SetDB, target_db: SetDB,
                     cfg: IterativeSearchConfig,
                     same_qt_db: bool | None = None, *,
                     device: torch.device | str,
                     metrics: list | None = None
                     ) -> dict[int, list[AlnRecord]]:
    """The iterative search of query_db against target_db; the SW passes
    run on `device`.  `metrics`, if given, gets one dict a round: the
    host-clock seconds of its index build, prefilter (with the
    subtraction), alignment and profile build (`index_s`, `prefilter_s`,
    `align_s`, `profiles_s`), the index's size (`index_mb`: the profile
    rounds post every k-mer of the targets), its candidate and record
    counts, and its SW
    engines' metrics (`align_detail`, or `forward_detail` and
    `realign_detail` for the acceptance pass and the realignment of round
    0)."""
    if same_qt_db is None:
        same_qt_db = query_db is target_db
    eval_intermediate = min(cfg.eval_thr, cfg.eval_profile)
    merged: dict[int, list[AlnRecord]] = {}
    pssms = aln_profiles = None

    for step in range(cfg.num_iterations):
        last = step == cfg.num_iterations - 1
        step_eval = cfg.eval_thr if last else eval_intermediate
        is_profile = step > 0
        m: dict = {"round": step}
        t0 = time.perf_counter()
        pref = PrefilterEngine(
            query_db, target_db, sensitivity=cfg.sensitivity,
            max_seqs=cfg.max_seqs, same_qt_db=same_qt_db and not is_profile,
            comp_bias_correction=cfg.comp_bias_correction, mask=cfg.mask,
            cov_thr=cfg.cov_thr, cov_mode=cfg.cov_mode,
            query_profiles=pssms if is_profile else None)
        m["index_s"] = time.perf_counter() - t0
        m["index_mb"] = index_bytes(pref.index) / 2**20
        t0 = time.perf_counter()
        cands = {qk: [h.seq_id for h in hits]
                 for qk, hits in pref.match_all().items()}
        if step > 0:
            cands = subtract_candidates(cands, merged, cfg.eval_profile)
        m["prefilter_s"] = time.perf_counter() - t0
        m["candidates"] = sum(len(v) for v in cands.values())
        t0 = time.perf_counter()

        aln_par = AlignmentParams(
            gap_open=cfg.gap_open, gap_extend=cfg.gap_extend,
            eval_thr=step_eval, cov_thr=cfg.cov_thr, cov_mode=cfg.cov_mode,
            aln_len_thr=cfg.aln_len_thr,
            comp_bias_correction=cfg.comp_bias_correction)
        if step == 0 and cfg.num_iterations > 1:
            # realign round: first pass without coverage filter
            records = align_with_realign(query_db, target_db, cands, aln_par,
                                         same_qt_db, device=device,
                                         metrics=m)
        else:
            eng = AlignmentEngine(query_db, target_db, aln_par,
                                  same_qt_db=same_qt_db and not is_profile,
                                  query_profiles=aln_profiles
                                  if is_profile else None, device=device)
            records = eng.align_all(cands)
            m["align_detail"] = dict(eng._device_db().metrics)
        m["align_s"] = time.perf_counter() - t0
        m["records"] = sum(len(v) for v in records.values())

        if step == 0:
            merged = records
        else:
            for qk, recs in records.items():
                merged.setdefault(qk, [])
                merged[qk] = merged.get(qk, []) + recs

        if not last:
            t0 = time.perf_counter()
            pssms, aln_profiles = build_profiles(query_db, target_db, merged,
                                                 cfg.eval_profile)
            m["profiles_s"] = time.perf_counter() - t0
        if metrics is not None:
            metrics.append(m)
    return merged


def align_with_realign(query_db: SetDB, target_db: SetDB,
                       cands: dict[int, list[int]],
                       par: AlignmentParams,
                       same_qt_db: bool, *,
                       device: torch.device | str,
                       metrics: dict | None = None
                       ) -> dict[int, list[AlnRecord]]:
    """Iteration-0 alignment with realign (Alignment.cpp:47-56,392-442):
    SCORE_ONLY acceptance on (eval, alnLen-proxy) with the coverage filter
    zeroed (the length pre-check keeps covThr), then realignment of
    accepted hits with the scoreBias -0.2 matrix filtered on realigned
    coverage; realigned records keep the original score/eval.  `metrics`,
    if given, gets the two engines' SW metrics (`forward_detail`,
    `realign_detail`)."""
    eng1 = AlignmentEngine(query_db, target_db, par, same_qt_db=same_qt_db,
                           device=device)
    accepted = eng1.forward_accepts(cands, par.eval_thr, par.aln_len_thr,
                                    par.cov_thr, par.cov_mode)

    realign_par = AlignmentParams(**{**par.__dict__, "eval_thr": float("inf"),
                                     "aln_len_thr": 0})
    realign_matrix = load_pinned_matrix("blosum62_bf2_bias")
    eng2 = AlignmentEngine(query_db, target_db, realign_par,
                           matrix=realign_matrix, same_qt_db=same_qt_db,
                           device=device)

    pairs = {qk: [r.tkey for r in recs if not (r.tkey == qk and same_qt_db)]
             for qk, recs in accepted.items()}
    realigned_all = eng2.align_all(pairs)
    if metrics is not None:
        metrics["forward_detail"] = dict(eng1._device_db().metrics)
        metrics["realign_detail"] = dict(eng2._device_db().metrics)

    out: dict[int, list[AlnRecord]] = {}
    for qk, recs in accepted.items():
        new_recs = {r.tkey: r for r in realigned_all.get(qk, [])}
        realigned = []
        for rec in recs:
            if rec.tkey == qk and same_qt_db:
                realigned.append(rec)
                continue
            new = new_recs.get(rec.tkey)
            if new is None:
                continue
            new.score = rec.score
            new.evalue = rec.evalue
            realigned.append(new)
        realigned.sort(key=lambda r: (r.evalue, -r.score, r.tlen, r.tkey))
        out[qk] = realigned
    return out
