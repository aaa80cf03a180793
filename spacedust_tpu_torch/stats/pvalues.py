"""P-value statistics chain for hit aggregation and clustering.

Float64 replicas of the reference's statistics tail:

  * ComputelogPval            (src/util/besthitbyset.cpp:10-20)
  * precomputeLogB/LBinCoeff  (lib/mmseqs/src/multihit/combinepvalperset.cpp:12-26)
  * truncated-Fisher multihit (src/util/combinehits.cpp:100-155)
  * Lanczos logGamma          (src/util/ClusterHits.cpp:24-63)
  * cluster/ordering P-values (src/util/ClusterHits.cpp:80-117)
  * per-cluster multihitPval  (src/util/ClusterHits.cpp:184-213)
"""

from __future__ import annotations

import math

import numpy as np

DBL_MIN = 2.2250738585072014e-308  # smallest normal double (C DBL_MIN)
DBL_MAX = 1.7976931348623157e308


def compute_log_pval(eval_: float, log_calibration: float = 0.0) -> float:
    """log P-value from an E-value (besthitbyset.cpp:10-20).

    Note the reference's `10e-4` literal (i.e. 1e-3) branch boundary.
    """
    if eval_ == 0:
        return math.log(DBL_MIN) - log_calibration
    elif 0 < eval_ < 10e-4:
        return math.log(eval_) - log_calibration
    else:
        return math.log(1 - math.exp(-eval_)) - log_calibration


def lbin_coeff(lgamma_lookup: np.ndarray, m: int, k: int) -> float:
    """log binomial coefficient via the lgamma lookup (combinepvalperset.cpp:12-14)."""
    return lgamma_lookup[m + 1] - lgamma_lookup[m - k + 1] - lgamma_lookup[k + 1]


def make_lgamma_lookup(max_orf_count: int) -> np.ndarray:
    """lookup[i] = lgamma(i) for i in [0, maxOrfCount+1] (combinehits.cpp:42-45).

    lookup[0] = lgamma(0) = +inf, as in C.
    """
    with np.errstate(divide="ignore"):
        from scipy.special import gammaln
        return gammaln(np.arange(max_orf_count + 2, dtype=np.float64))


def precompute_log_b(orf_count: int, pval_threshold: float,
                     lgamma_lookup: np.ndarray) -> np.ndarray:
    """logB tail coefficients (combinepvalperset.cpp:16-26), sequential f64."""
    log_b = np.empty(orf_count, dtype=np.float64)
    log_thr = math.log(pval_threshold)
    log_one_minus = math.log(1 - pval_threshold)
    log_b[orf_count - 1] = orf_count * log_thr
    for i in range(orf_count - 2, -1, -1):
        k = i + 1
        log_new_term = (lbin_coeff(lgamma_lookup, orf_count, k)
                        + k * log_thr + (orf_count - k) * log_one_minus)
        log_b[i] = log_b[i + 1] + math.log(1 + math.exp(log_new_term - log_b[i + 1]))
    return log_b


def truncated_fisher_pval(log_pvals: np.ndarray, orf_count: int,
                          log_b: np.ndarray, lgamma_lookup: np.ndarray,
                          pval_threshold: float) -> tuple[int, float]:
    """Combined multihit P-value of one (query set, target set) pair.

    Returns (k, combined_pval) following combinehits.cpp:100-155. The
    selection threshold is the hardcoded p0 = 10e-7 (1e-6) while log_b is
    computed with alpha/(orfCount+1) — the reference's deliberate mismatch.
    Caller handles the k==0 / r==0 "emit nothing" cases: combined_pval is
    returned as None in that case.
    """
    log_thr = math.log(pval_threshold)
    mask = log_pvals < log_thr
    k = int(mask.sum())
    r = float(-(log_pvals[mask] - log_thr).sum())
    if r == 0 or k == 0:
        return k, None
    if math.isinf(r):
        return k, 0.0
    exp_minus_r = math.exp(-r)
    if exp_minus_r == 0:
        return k, 0.0
    log_r = math.log(r)
    i = np.arange(orf_count, dtype=np.float64)
    total = float(np.exp(i * log_r - lgamma_lookup[1:orf_count + 1]
                         + log_b[:orf_count]).sum())
    return k, exp_minus_r * total


# ---------------------------------------------------------------------------
# clusterhits math (src/util/ClusterHits.cpp)
# ---------------------------------------------------------------------------

_GAMMA_R10 = 10.900511
_GAMMA_DK = (
    2.48574089138753565546e-5,
    1.05142378581721974210,
    -3.45687097222016235469,
    4.51227709466894823700,
    -2.98285225323576655721,
    1.05639711577126713077,
    -1.95428773191645869583e-1,
    1.70970543404441224307e-2,
    -5.71926117404305781283e-4,
    4.63399473359905636708e-6,
    -2.71994908488607703910e-9,
)
_GAMMA_C = 2 * math.sqrt(math.e / math.pi)


def log_gamma(x: float) -> float:
    """Lanczos logGamma exactly as ClusterHits.cpp:42-63.

    NB the reference calls C++ abs() on a double inside the reflection
    branch; with <cmath> pulled in, std::abs(double) applies (fabs).
    """
    if x < 0.5:
        return math.log(math.pi) - math.log(abs(math.sin(math.pi * x))) - log_gamma(1 - x)
    elif x == 1:
        return 0.0
    s = _GAMMA_DK[0]
    for i in range(1, 11):
        s += _GAMMA_DK[i] / (x + (i - 1))
    return (math.log(_GAMMA_C) + (x - 0.5) * math.log(x + _GAMMA_R10 - 0.5)
            - (x - 0.5) + math.log(s))


def make_cluster_lgamma_lookup(max_orf_count: int) -> np.ndarray:
    """clusterhits builds its lookup from the Lanczos logGamma, NOT lgamma
    (ClusterHits.cpp:267-271); lookup[0] = logGamma(0) = +inf via log(|sin 0|)
    ... actually logGamma(0) hits the x<0.5 branch: log(pi)-log(0)-... = +inf.
    """
    out = np.empty(max_orf_count + 2, dtype=np.float64)
    for i in range(max_orf_count + 2):
        if i == 0:
            out[i] = math.inf
        else:
            out[i] = log_gamma(float(i))
    return out


def log_cluster_pval(lookup: np.ndarray, k: int, m: int, q0: float = 0.001) -> float:
    """ClusterHits.cpp:80-82: 2*log m! - 2*log (m-k)! - log k! + k log q0."""
    return 2 * lookup[m + 1] - 2 * lookup[m - k + 1] - lookup[k + 1] + k * math.log(q0)


def log_ordering_pval(lookup: np.ndarray, k: int, m: int) -> float:
    """ClusterHits.cpp:84-86: log(1 - m/k) - m log 2 - log m!."""
    return math.log(1 - 1.0 * m / k) - m * math.log(2) - lookup[m + 1]


def cluster_multihit_pval(pvals: np.ndarray, nq: int, alpha: float,
                          lookup: np.ndarray) -> float:
    """Per-cluster multihit P-value (ClusterHits.cpp:184-213)."""
    pval_threshold = alpha / (nq + 1)
    log_thr = math.log(pval_threshold)
    k = 0
    r = 0.0
    for p in pvals:
        logp = math.log(p) if p > 0 else -math.inf
        if logp < log_thr:
            k += 1
            r -= logp - log_thr
    if r == 0:
        return 1.0
    if math.isinf(r):
        return 0.0
    exp_minus_r = math.exp(-r)
    if exp_minus_r == 0:
        return 0.0
    s = 0.0
    for i in range(k - 1):
        s += math.pow(r, i) / math.exp(lookup[i + 1])
    return exp_minus_r * s
