"""The scores the plain reference aligns with, worked out again from the
raw tables in `data/`: the published half-bit BLOSUM62 (with its
background and lambda), and the pinned BLOSUM62 / mat3di integer tables
that the structure search combines.

The chains follow MMseqs2 and Foldseek, as the program states them:
  * the alignment matrix (SubstitutionMatrix / BaseMatrix): backgrounds
    scaled by (1 - p[X]), joint probabilities exp(lambda s) p_i p_j, row
    backgrounds, log2 odds, times the bit factor 2, rounded half away
    from zero;
  * the local composition bias of a query position
    (SubstitutionMatrix::calcLocalAaBiasCorrection): minus the mean score
    of the residue against a +-20 window (itself left out) plus its
    background-expected score, accumulated in float32, rounded to int8;
  * the structure search's cell: mat3di[q_ss, t_ss] + 3Di bias, and
    round(0.7 * BLOSUM62[q_aa, t_aa]), each channel cast to int8 on its
    own;
  * bit scores (lambda raw - ln K) / ln 2, rounded to the nearest integer,
    and E-values K exp(-lambda raw) area(raw, query length, the DB's
    residues), the area of ALP's finite-size correction
    (sls_pvalues.cpp, get_appr_tail_prob_with_cov_without_errors):
    BLOSUM62 gapped 11/1's Gumbel parameters (MMseqs2 EvalueComputation.h)
    for the sequence search; for the structure search the ungapped lambda
    of the combined matrix under the product background, K = 300, and
    a = alpha = sigma = 1 / H (H the relative entropy of the aligned-pair
    distribution at that lambda), b = beta = tau = 0.
"""

from __future__ import annotations

import json
import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

AA_ORDER = "ACDEFGHIKLMNPQRSTVWYX"
X = AA_ORDER.index("X")
DATA = Path(__file__).resolve().parent / "data"

# MMseqs2 EvalueComputation.h: BLOSUM62, gap open 11, extend 1: lambda,
# K, a_J, b_J, a_I, b_I, alpha_J, beta_J, alpha_I, beta_I, sigma, tau
SEQ_GUMBEL = (0.27359865037097330642, 0.044620920658722244834,
              1.5938724404943873658, -19.959867650284412122,
              1.5938724404943873658, -19.959867650284412122,
              30.455610143099914211, -622.28684628915891608,
              30.455610143099914211, -622.28684628915891608,
              29.602444874818868215, -601.81087985041381216)
SEQ_LAMBDA, SEQ_K = SEQ_GUMBEL[:2]
STRUCT_K = 300.0


def c_round(x: np.ndarray) -> np.ndarray:
    """C's (x < 0) ? x - 0.5 : x + 0.5, truncated."""
    return np.where(x < 0.0, x - 0.5, x + 0.5).astype(np.int64)


@lru_cache(maxsize=1)
def blosum62() -> tuple[np.ndarray, np.ndarray]:
    """(21 x 21 int32 scores at bit factor 2, 21 backgrounds) from the
    half-bit table."""
    raw = json.loads((DATA / "blosum62.json").read_text())
    if "".join(raw["order"]) != AA_ORDER:
        raise ValueError("blosum62.json: unexpected alphabet order")
    lam = float(raw["lambda"])
    scores = np.asarray(raw["scores"], dtype=np.float64)
    p = np.asarray(raw["background"], dtype=np.float64).copy()
    p[:X] = p[:X] * (1.0 - p[X])
    prob = np.exp(lam * scores) * p[:, None] * p[None, :]
    q = prob.sum(axis=1)
    q[X] = 1e-5
    sub = c_round(2.0 * np.log2(prob / (q[:, None] * q[None, :])))
    return sub.astype(np.int32), p


@lru_cache(maxsize=2)
def pinned(name: str) -> tuple[np.ndarray, np.ndarray]:
    raw = json.loads((DATA / f"{name}.json").read_text())
    if raw["alphabet"] != AA_ORDER:
        raise ValueError(f"{name}.json: unexpected alphabet order")
    return (np.asarray(raw["sub_int"], dtype=np.int32),
            np.asarray(raw["background"], dtype=np.float64))


def comp_bias(seq: np.ndarray, sub: np.ndarray, p_back: np.ndarray
              ) -> np.ndarray:
    """int8 local composition bias of each position of seq."""
    n = len(seq)
    nsym = sub.shape[0]
    half = 20
    prefix = np.zeros((nsym, n + 1), dtype=np.int64)
    for c in range(nsym):
        prefix[c, 1:] = np.cumsum(seq == c)
    idx = np.arange(n)
    lo = np.maximum(0, idx - half)
    hi = np.minimum(n, idx + half)
    win = (hi - lo).astype(np.float64)
    counts = prefix[:, hi] - prefix[:, lo]
    row = sub[seq].astype(np.int64)
    total = np.einsum("nc,cn->n", row, counts) - sub[seq, seq]
    delta = np.float32(total.astype(np.float32).astype(np.float64)
                       / (-1.0 * win))
    for a in range(nsym):
        delta = np.float32(delta.astype(np.float64)
                           + p_back[a] * row[:, a].astype(np.float64))
    d = delta.astype(np.float64)
    return np.where(d < 0.0, d - 0.5, d + 0.5).astype(np.int8)


@lru_cache(maxsize=1)
def struct_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """(mat3di, its backgrounds, the scaled amino-acid table, lambda)."""
    m3, p3_back = pinned("mat3di")
    b62, b62_back = pinned("blosum62_bf2")
    aa = c_round(0.7 * b62.astype(np.float64)).astype(np.int32)
    p3 = p3_back[:20] / p3_back[:20].sum()
    paa = b62_back[:20] / b62_back[:20].sum()
    s3 = m3[:20, :20].astype(np.float64)
    saa = aa[:20, :20].astype(np.float64)

    def expect(lam):
        return float((p3[:, None] * p3[None, :] * np.exp(lam * s3)).sum()
                     * (paa[:, None] * paa[None, :]
                        * np.exp(lam * saa)).sum())

    lo, hi = 1e-6, 2.0
    while expect(hi) < 1.0:
        hi *= 2
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if expect(mid) < 1.0:
            lo = mid
        else:
            hi = mid
    return m3, p3_back, aa, 0.5 * (lo + hi)


@lru_cache(maxsize=1)
def struct_gumbel() -> tuple:
    """The structure search's 12 Gumbel parameters (SEQ_GUMBEL's order)."""
    m3, p3_back, aa, lam = struct_tables()
    p3 = p3_back[:20] / p3_back[:20].sum()
    _b62, b62_back = pinned("blosum62_bf2")
    paa = b62_back[:20] / b62_back[:20].sum()
    s3 = m3[:20, :20].astype(np.float64)
    saa = aa[:20, :20].astype(np.float64)
    w3 = p3[:, None] * p3[None, :] * np.exp(lam * s3)
    waa = paa[:, None] * paa[None, :] * np.exp(lam * saa)
    h = ((w3 * lam * s3).sum() * waa.sum()
         + (waa * lam * saa).sum() * w3.sum()) / (w3.sum() * waa.sum())
    return (lam, STRUCT_K) + (1.0 / h, 0.0) * 5


def gumbel(kind: str) -> tuple:
    return SEQ_GUMBEL if kind == "seq" else struct_gumbel()


def bit_scores(raw: np.ndarray, kind: str) -> np.ndarray:
    lam, k = gumbel(kind)[:2]
    bits = (lam * np.asarray(raw, dtype=np.float64) - math.log(k)) \
        / math.log(2.0)
    return (bits + 0.5).astype(np.int64)


def evalues(raw: np.ndarray, qlen: np.ndarray, db_residues: int,
            kind: str) -> np.ndarray:
    """E-value of each raw score against a query of length qlen."""
    lam, k, a_j, b_j, a_i, b_i, al_j, be_j, al_i, be_i, sig, tau = \
        gumbel(kind)
    y = torch.as_tensor(np.asarray(raw, np.float64))
    n = torch.as_tensor(np.asarray(qlen, np.float64))
    m = float(db_residues)

    def phi(x):                                   # the normal CDF
        return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))

    def side(length, a, b, alpha, beta):
        rest = length - (a * y + b)
        var = torch.clamp(alpha * y + beta, min=max(2.0 * alpha / lam, 0.0))
        sd = torch.sqrt(var)
        z = torch.where(sd == 0, torch.full_like(rest, 1e100),
                        rest / torch.where(sd == 0, 1.0, sd))
        dens = -torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        return rest * phi(z) - sd * dens, phi(z)

    p1, pm = side(m, a_i, b_i, al_i, be_i)
    p2, pn = side(n, a_j, b_j, al_j, be_j)
    c = torch.clamp(sig * y + tau, min=max(2.0 * sig / lam, 0.0))
    area = p1 * p2 + c * pm * pn
    return (k * torch.exp(-lam * y) * area).numpy()


def seq_id_text(ident: int, aln_len: int) -> str:
    """The identity column as MMseqs2 prints it (fastSeqIdToBuffer of the
    float32 identical / alignment length): "1.00" for 1, else "0." and
    the truncated thousandths, zero-padded to three digits."""
    s = np.float32(ident) / np.float32(aln_len)
    if s == np.float32(1.0):
        return "1.00"
    return ("0." + ("0" if s < np.float32(0.10) else "")
            + ("0" if s < np.float32(0.01) else "")
            + str(int(s * np.float32(1000))))
