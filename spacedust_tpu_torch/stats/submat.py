"""Substitution-matrix construction.

Reproduces, in float64 numpy, the numeric chain the reference uses to turn
the bundled half-bit BLOSUM62 table into integer alignment scores:

  1. parse half-bit scores, background frequencies and lambda
     (SubstitutionMatrix::readProbMatrix,
      lib/mmseqs/src/commons/SubstitutionMatrix.cpp:326-420)
  2. pBack[i] *= (1 - pBack[X]) for the 20 standard residues (X stays 1e-5)
  3. prob[i][j] = exp(lambda * s[i][j]) * pBack[i] * pBack[j]
  4. row background qBack[i] = sum_j prob[i][j]; qBack[X] = 1e-5
     (BaseMatrix::computeBackground, lib/mmseqs/src/commons/BaseMatrix.cpp:97-107)
  5. float matrix  f[i][j] = log2(prob[i][j] / (qBack[i] qBack[j]))
  6. integer score s_int[i][j] = c_round(bitFactor * f[i][j] + scoreBias)
     with C-style round-half-away-from-zero
     (BaseMatrix::generateSubMatrix, lib/mmseqs/src/commons/BaseMatrix.cpp:141-159)

The alignment stage uses bitFactor=2.0, scoreBias=0.0
(lib/mmseqs/src/alignment/Alignment.cpp:152).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..constants import AA_ORDER, ALPHABET_SIZE, X_INDEX

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"


def c_round(x: np.ndarray) -> np.ndarray:
    """C-style (pVal < 0.0) ? pVal - 0.5 : pVal + 0.5 truncation-rounding."""
    return np.where(x < 0.0, x - 0.5, x + 0.5).astype(np.int64)


@dataclass(frozen=True)
class SubstitutionMatrix:
    name: str                 # e.g. "blosum62.out" (kept for E-value param lookup)
    lam: float                # file lambda (half-bit scale)
    p_back: np.ndarray        # background after (1-pX) scaling, shape (21,)
    prob: np.ndarray          # joint probabilities, shape (21, 21)
    sub_float: np.ndarray     # bit-scale float scores
    sub_int: np.ndarray       # integer scores (bitFactor applied), int32
    bit_factor: float

    @property
    def alphabet_size(self) -> int:
        return ALPHABET_SIZE

    def score(self, a: str, b: str) -> int:
        return int(self.sub_int[AA_ORDER.index(a), AA_ORDER.index(b)])


@lru_cache(maxsize=8)
def load_substitution_matrix(name: str = "blosum62",
                             bit_factor: float = 2.0,
                             score_bias: float = 0.0) -> SubstitutionMatrix:
    raw = json.loads((_DATA_DIR / f"{name}.json").read_text())
    order = "".join(raw["order"])
    assert order == AA_ORDER, f"matrix order mismatch: {order}"
    lam = float(raw["lambda"])
    scores = np.asarray(raw["scores"], dtype=np.float64)
    p_back = np.asarray(raw["background"], dtype=np.float64)

    # X column is never positive in the bundled matrices -> scale the 20
    # standard backgrounds by (1 - pBack[X]) as the reference does.
    p_back = p_back.copy()
    p_back[:X_INDEX] = p_back[:X_INDEX] * (1.0 - p_back[X_INDEX])

    prob = np.exp(lam * scores) * p_back[:, None] * p_back[None, :]

    q_back = prob.sum(axis=1)
    q_back[X_INDEX] = 1e-5  # BaseMatrix::ANY_BACK

    sub_float = np.log2(prob / (q_back[:, None] * q_back[None, :]))
    sub_int = c_round(bit_factor * sub_float + score_bias).astype(np.int32)

    return SubstitutionMatrix(
        name=f"{name}.out",
        lam=lam,
        p_back=p_back,
        prob=prob,
        sub_float=sub_float,
        sub_int=sub_int,
        bit_factor=bit_factor,
    )


@lru_cache(maxsize=8)
def load_pinned_matrix(name: str) -> SubstitutionMatrix:
    """Load a pinned derived matrix (data/derived/*.json).

    These are exact dumps of the reference's matrix-construction output
    (integer scores, background, lambda, joint probabilities) for specific
    (matrix, bitFactor) combos — the same pinning pattern the reference
    uses for its Gumbel parameters (EvalueComputation.h:56-78). Guarantees
    ulp-exact probability ratios for tantan masking.
    Available: "vtml80_bf8" / "vtml80_bf8_bias" (k-mer seed matrix),
    "blosum62_bf2" / "blosum62_bf2_bias" (ungapped rescore), and the
    pinned 3Di structural matrix "mat3di" (Foldseek mat3di.out) plus its
    seed-scale variant "mat3di_bf8_bias" (scores rescaled from the native
    ~2-bit integers to the bit-factor-8 seed scale with the -0.2 score
    bias: round(4*s - 1.6)).
    """
    if name == "mat3di_bf8_bias":
        base = load_pinned_matrix("mat3di")
        sub = c_round(4.0 * base.sub_int.astype(np.float64) - 1.6).astype(
            np.int32)
        sub[X_INDEX, :] = 0
        sub[:, X_INDEX] = 0
        return SubstitutionMatrix(
            name="mat3di.out", lam=base.lam / 4.0, p_back=base.p_back,
            prob=base.prob, sub_float=base.sub_float, sub_int=sub,
            bit_factor=8.0)
    raw = json.loads((_DATA_DIR / "derived" / f"{name}.json").read_text())
    assert raw["alphabet"] == AA_ORDER
    prob = np.asarray(raw["prob"], dtype=np.float64)
    sub_int = np.asarray(raw["sub_int"], dtype=np.int32)
    p_back = np.asarray(raw["background"], dtype=np.float64)
    q_back = prob.sum(axis=1)
    q_back[X_INDEX] = 1e-5
    return SubstitutionMatrix(
        name=raw["name"].split("/")[-1],
        lam=float(raw["lambda"]),
        p_back=p_back,
        prob=prob,
        sub_float=np.log2(prob / (q_back[:, None] * q_back[None, :])),
        sub_int=sub_int,
        bit_factor=float(raw["bit_factor"]),
    )


def local_aa_bias_correction(seq: np.ndarray,
                             sub_int: np.ndarray,
                             p_back: np.ndarray,
                             scale: float = 1.0) -> np.ndarray:
    """Per-position composition-bias correction, bit-exact float32 chain.

    Mirrors SubstitutionMatrix::calcLocalAaBiasCorrection
    (lib/mmseqs/src/commons/SubstitutionMatrix.cpp:79-109): for each
    position i, deltaS_i = -avg of sub scores of residue i against a +/-20
    window (own position excluded) plus the background-expected score.
    The reference accumulates into a C `float`, so every arithmetic step
    here is rounded to float32 to match bit-for-bit.
    """
    n = seq.shape[0]
    nsym = sub_int.shape[0]
    half = 20  # windowSize 40 / 2
    # counts[c, i] = number of j in window(i) with seq[j] == c (via prefix sums)
    prefix = np.zeros((nsym, n + 1), dtype=np.int64)
    for c in range(nsym):
        prefix[c, 1:] = np.cumsum(seq == c)
    idx = np.arange(n)
    lo = np.maximum(0, idx - half)
    hi = np.minimum(n, idx + half)
    win_len = (hi - lo).astype(np.float64)
    counts = prefix[:, hi] - prefix[:, lo]            # (nsym, n)
    row = sub_int[seq].astype(np.int64)               # (n, nsym)
    sum_sub = np.einsum("nc,cn->n", row, counts)      # exact int windowed sum
    sum_sub -= sub_int[seq, seq]                      # remove own amino acid
    # float deltaS_i = sumSubScores; deltaS_i /= -(double)windowLength;
    delta = np.float32(sum_sub.astype(np.float32).astype(np.float64) /
                       (-1.0 * win_len))
    # sequential f32 accumulation of pBack[a] * subMat[row][a]
    for a in range(nsym):
        delta = np.float32(delta.astype(np.float64) +
                           p_back[a] * row[:, a].astype(np.float64))
    return np.float32(np.float32(scale) * delta)
