"""Karlin-Altschul/Gumbel E-value statistics.

Pinned finite-size-correction (FSC) Gumbel parameters and the closed-form
`area` integral from the reference's vendored ALP library — replicated as
pure float64 formulas rather than re-simulated:

  * parameter sets: EvalueComputation.h:56-78 (blosum62 gapped 11/1,
    blosum62 ungapped, nucleotide 7/1)
  * parameter wiring: sls_alignment_evaluer.cpp:657-842 (initParameters):
    array order is {lambda, K, a1, b1, a2, b2, alpha1, beta1, alpha2,
    beta2, sigma, tau}; a_J=a1, a_I=a2 etc.
  * area formula: sls_pvalues.cpp:366-553
    (get_appr_tail_prob_with_cov_without_errors) with
    vi_y_thr = max(2*alpha_I/lambda, 0) etc. (sls_pvalues.cpp:341-365)
  * normal_probability(x) = 0.5*erfc(-sqrt(0.5)*x)  (sls_basic.hpp:195-198)
  * E-value = K * exp(-lambda*score) * area(score, qLen, dbResCount)
    (EvalueComputation.h:35-40: evaluePerArea * area)
  * bitScore(score) = (lambda*score - log K)/log 2 (sls_alignment_evaluer.hpp:159-162)
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy.special import erfc

_SQRT_HALF = math.sqrt(0.5)
_CONST_VAL = 1.0 / math.sqrt(2.0 * math.pi)


@dataclass(frozen=True)
class GumbelParams:
    lam: float
    K: float
    a_J: float
    b_J: float
    a_I: float
    b_I: float
    alpha_J: float
    beta_J: float
    alpha_I: float
    beta_I: float
    sigma: float
    tau: float

    @property
    def vi_y_thr(self) -> float:  # sls_pvalues.cpp:352
        return max(2.0 * self.alpha_I / self.lam, 0.0)

    @property
    def vj_y_thr(self) -> float:
        return max(2.0 * self.alpha_J / self.lam, 0.0)

    @property
    def c_y_thr(self) -> float:
        return max(2.0 * self.sigma / self.lam, 0.0)


def _params_from_array(a) -> GumbelParams:
    lam, k, a1, b1, a2, b2, al1, be1, al2, be2, sigma, tau = a
    return GumbelParams(lam=lam, K=k, a_J=a1, b_J=b1, a_I=a2, b_I=b2,
                        alpha_J=al1, beta_J=be1, alpha_I=al2, beta_I=be2,
                        sigma=sigma, tau=tau)


# EvalueComputation.h:56-78 — verbatim constants.
BLOSUM62_GAPPED_11_1 = _params_from_array([
    0.27359865037097330642, 0.044620920658722244834,
    1.5938724404943873658, -19.959867650284412122,
    1.5938724404943873658, -19.959867650284412122,
    30.455610143099914211, -622.28684628915891608,
    30.455610143099914211, -622.28684628915891608,
    29.602444874818868215, -601.81087985041381216])

BLOSUM62_UNGAPPED = _params_from_array([
    0.3207378152604042354, 0.13904657125294345166,
    0.76221128839920349041, 0,
    0.76221128839920349041, 0,
    4.5269915477182944841, 0,
    4.5269915477182944841, 0,
    4.5269915477182944841, 0])

NUCLEOTIDE_7_1 = _params_from_array([
    1.0960171987681839, 0.33538787507026158,
    2.0290734315292083, -0.46514786408422282,
    2.0290734315292083, -0.46514786408422282,
    5.0543294182155085, 15.130999712620039,
    5.0543294182155085, 15.130999712620039,
    5.0543962679167036, 15.129930117400917])


def _normal_probability(x):
    return 0.5 * erfc(-_SQRT_HALF * x)


class EvalueComputation:
    """E-value/bit-score calculator for a fixed target-DB residue count.

    Mirrors lib/mmseqs/src/alignment/EvalueComputation.h. `db_res_count`
    is DBReader::getAminoAcidDBSize of the target DB (= total residues).
    """

    def __init__(self, db_res_count: int,
                 params: GumbelParams = BLOSUM62_GAPPED_11_1):
        self.db_res_count = float(db_res_count)
        self.p = params
        self.log_k = math.log(params.K)

    # --- ALP area (sls_pvalues.cpp:366-553), vectorized over score ---
    def area(self, score, query_len):
        p = self.p
        y = np.asarray(score, dtype=np.float64)
        m = self.db_res_count           # m_ = seqlen2_ = dbResCount
        n = np.asarray(query_len, dtype=np.float64)  # n_ = seqlen1_ = qLen

        m_li_y = m - (p.a_I * y + p.b_I)
        vi_y = np.maximum(p.vi_y_thr, p.alpha_I * y + p.beta_I)
        sqrt_vi_y = np.sqrt(vi_y)
        m_F = np.where(sqrt_vi_y == 0.0, 1e100, m_li_y / np.where(sqrt_vi_y == 0.0, 1.0, sqrt_vi_y))
        P_m_F = _normal_probability(m_F)
        E_m_F = -_CONST_VAL * np.exp(-0.5 * m_F * m_F)
        p1 = m_li_y * P_m_F - sqrt_vi_y * E_m_F

        n_lj_y = n - (p.a_J * y + p.b_J)
        vj_y = np.maximum(p.vj_y_thr, p.alpha_J * y + p.beta_J)
        sqrt_vj_y = np.sqrt(vj_y)
        n_F = np.where(sqrt_vj_y == 0.0, 1e100, n_lj_y / np.where(sqrt_vj_y == 0.0, 1.0, sqrt_vj_y))
        P_n_F = _normal_probability(n_F)
        E_n_F = -_CONST_VAL * np.exp(-0.5 * n_F * n_F)
        p2 = n_lj_y * P_n_F - sqrt_vj_y * E_n_F

        c_y = np.maximum(p.c_y_thr, p.sigma * y + p.tau)
        return p1 * p2 + c_y * P_m_F * P_n_F

    def evalue_per_area(self, score):
        return self.p.K * np.exp(-self.p.lam * np.asarray(score, dtype=np.float64))

    def compute_evalue(self, score, query_len):
        return self.evalue_per_area(score) * self.area(score, query_len)

    def compute_log_evalue(self, score, query_len):
        ev = np.maximum(self.compute_evalue(score, query_len),
                        np.finfo(np.float64).tiny)
        return np.log(ev)

    def compute_bit_score(self, score):
        return (self.p.lam * np.asarray(score, dtype=np.float64) - self.log_k) / math.log(2.0)

    def bit_score_int(self, score):
        """Integer bit score as stored in alignment records (Matcher.cpp:130:
        static_cast<int>(computeBitScore(score)+0.5))."""
        return (self.compute_bit_score(score) + 0.5).astype(np.int64) \
            if isinstance(score, np.ndarray) else int(self.compute_bit_score(score) + 0.5)

    def compute_raw_score_from_bit_score(self, bit_score):
        """Inverse of computeBitScore (EvalueComputation.h:22-24), used by
        swapresults to re-derive the raw score before recomputing the
        E-value in the swapped direction (Matcher.h:93-95)."""
        return (self.log_k + np.asarray(bit_score, dtype=np.float64)
                * math.log(2.0)) / self.p.lam

    def min_score(self, evalue: float, query_len: float) -> int:
        # EvalueComputation.h:26-30
        s = (math.log(self.p.K * float(self.area(60.0, query_len)))
             - math.log(evalue)) / self.p.lam
        return int(math.ceil(max(1.0, s)))
