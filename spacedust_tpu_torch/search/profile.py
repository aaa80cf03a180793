"""Profile (PSSM) construction: result2profile's core math.

Builds a position-specific scoring profile from a query and its accepted
alignment records, following lib/mmseqs/src/alignment/
{MultipleAlignment,PSSMCalculator}.cpp:

  * center-star MSA from backtraces with query columns only
    (computeMSA with noDeletionMSA=true as used by result2profile)
  * Henikoff position-based sequence weights (PSSMCalculator.cpp:311-374)
  * position-specific (context) weights + Neff (computeContextSpecificWeights,
    PSSMCalculator.cpp:585-...) — the default wg=0 path
  * substitution-matrix pseudocounts (preparePseudoCounts/computePseudoCounts)
  * consensus sequence and int8 log-PSSM (computeLogPSSM with the fast
    flog2/fpow2 float32 approximations of MathUtil.h:107-146, replicated
    bit-exactly)
  * 25-byte/position serialization (Profile::toBuffer)

Deviation from the reference (documented): the reference computes
per-column weight contributions with an approximate SIMD reciprocal +
one Newton-Raphson step (PSSMCalculator.cpp:505-517); we use the exact
reciprocal, which can move borderline int8 PSSM scores by one unit.
The MSA diversity filter (MsaFilter) is not yet implemented; profiles
correspond to --filter-msa 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stats.submat import SubstitutionMatrix, load_substitution_matrix
from ..search.records import AlnRecord

NAA = 20
ANY = 20
GAP = 21
ENDGAP = 22
PROFILE_READIN_SIZE = 25


# ---------------------------------------------------------------------------
# fast float32 log2/pow2 (MathUtil::flog2 / fpow2), vectorized bit-exact
# ---------------------------------------------------------------------------

def flog2(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    out = np.full(x.shape, -128.0, dtype=np.float32)
    pos = x > 0
    xv = x[pos]
    bits = xv.view(np.int32)
    e = (((bits & 0x7F800000) >> 23) - 0x7F).astype(np.float32)
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(np.float32)
    m = (m - np.float32(1.0)).astype(np.float32)
    poly = np.float32(1.441740) + m * (
        np.float32(-0.7077702) + m * (
            np.float32(0.4123442) + m * (
                np.float32(-0.1903190) + m * np.float32(0.0440047))))
    out[pos] = (m * poly + e).astype(np.float32)
    return out


def fpow2(x: np.ndarray) -> np.ndarray:
    x = np.atleast_1d(np.asarray(x, dtype=np.float32)).copy()
    hi = x >= 128
    lo = x <= -125
    tx = (x - np.float32(0.5)) + np.float32(3 << 22)
    lx = tx.view(np.int32) - 0x4B400000
    dx = (x - lx.astype(np.float32)).astype(np.float32)
    y = np.float32(1.0) + dx * (
        np.float32(0.693019) + dx * (
            np.float32(0.241404) + dx * (
                np.float32(0.0520749) + dx * np.float32(0.0134929))))
    bits = y.view(np.int32) + (lx << 23)
    out = bits.view(np.float32).copy()
    out[hi] = np.finfo(np.float32).max
    out[lo] = 0.0
    return out


def normalize_to_1(arr: np.ndarray, default: np.ndarray | None = None) -> np.ndarray:
    """MathUtil::NormalizeTo1 f32 semantics (factor = 1/sum)."""
    s = arr.sum(dtype=np.float32)
    if s != np.float32(0.0):
        return (arr * (np.float32(1.0) / s)).astype(np.float32)
    if default is not None:
        return default.astype(np.float32).copy()
    return arr


# ---------------------------------------------------------------------------
# MSA construction (MultipleAlignment::computeMSA, noDeletionMSA=true)
# ---------------------------------------------------------------------------

def compute_msa(center: np.ndarray, targets: list[np.ndarray],
                records: list[AlnRecord]) -> np.ndarray:
    """Returns an (setSize+1, L) int8 MSA matrix of residue codes with
    GAP=21; row 0 is the (ungapped) query. noDeletionMSA=true: target
    insertions relative to the query are dropped."""
    L = len(center)
    rows = [center.astype(np.int8)]
    for tseq, rec in zip(targets, records):
        row = np.full(L, GAP, dtype=np.int8)
        qpos = rec.qstart
        tpos = rec.tstart
        for op in rec.backtrace:
            if op == "M":
                row[qpos] = tseq[tpos]
                qpos += 1
                tpos += 1
            elif op == "I":
                qpos += 1
            else:  # D: target insertion — dropped in noDeletionMSA
                tpos += 1
        rows.append(row)
    return np.stack(rows)


# ---------------------------------------------------------------------------
# PSSM computation
# ---------------------------------------------------------------------------

@dataclass
class Profile:
    pssm: np.ndarray         # (L, 20) int8 scores
    probs: np.ndarray        # (L, 20) float32 probabilities
    neff_m: np.ndarray       # (L,) float32
    consensus: np.ndarray    # (L,) uint8 residue codes
    query: np.ndarray        # (L,) uint8

    def to_buffer(self) -> bytes:
        """Profile::toBuffer 25-byte/pos serialization (PSSMCalculator.cpp:671-687)."""
        L = self.pssm.shape[0]
        out = np.zeros((L, PROFILE_READIN_SIZE), dtype=np.uint8)
        out[:, :NAA] = self.pssm.view(np.uint8)
        out[:, NAA] = self.query
        out[:, NAA + 1] = self.consensus
        neff = np.minimum(np.float32(255.0),
                          np.float32(1.0) + np.float32(64.0) * flog2(self.neff_m))
        out[:, NAA + 2] = np.maximum(1, (neff + 0.5).astype(np.uint8))
        return out.tobytes()


def _pseudocount_matrix(matrix: SubstitutionMatrix) -> np.ndarray:
    """R[a][b] = P(a,b)/pBack[b] with computeBackground row sums
    (BaseMatrix.cpp:110-122), as float32."""
    q_back = matrix.prob.sum(axis=1)
    q_back[NAA] = 1e-5
    return (matrix.prob / q_back[None, :]).astype(np.float32)


def compute_sequence_weights(msa: np.ndarray) -> np.ndarray:
    """Henikoff position-based weights (computeSequenceWeights): each
    sequence accumulates, column after column in float32, 1 / (count of
    its residue in the column x distinct residues there x (its residue
    count + 30)).  The terms are formed for all columns at once; the
    accumulation stays sequential (cumsum), so the sums are bit-equal to
    a column loop."""
    set_size, L = msa.shape
    number_res = (msa != GAP).sum(axis=1).astype(np.float32)
    aa = msa < NAA
    counts = np.stack([(msa == a).sum(axis=0) for a in range(NAA)])
    distinct = (counts > 0).sum(axis=0).astype(np.float32)      # (L,)
    nl = counts[np.where(aa, msa, 0).astype(np.int64),
                np.arange(L)[None, :]].astype(np.float32)       # (S, L)
    den = (nl * distinct[None, :]) * (number_res[:, None] + np.float32(30.0))
    contrib = np.zeros((set_size, L + 1), dtype=np.float32)
    contrib[:, 0] = np.float32(1e-6)
    np.divide(np.float32(1.0), den, out=contrib[:, 1:], where=aa)
    return np.cumsum(contrib, axis=1, dtype=np.float32)[:, -1]


def compute_context_weights(msa: np.ndarray, wg: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Position-specific weights + Neff (computeContextSpecificWeights).
    Returns (matchWeight (L,20) f32, Neff_M (L,) f32). Mutates a copy of
    the MSA with ENDGAP markers like the reference."""
    MAXENDGAPFRAC = 0.1
    NCOLMIN = 20
    set_size, L = msa.shape
    X = msa.copy()
    # endgaps
    for k in range(set_size):
        i = 0
        while i < L and X[k, i] == GAP:
            X[k, i] = ENDGAP
            i += 1
        i = L - 1
        while i >= 0 and X[k, i] == GAP:
            X[k, i] = ENDGAP
            i -= 1

    n = np.zeros((L, 24), dtype=np.int64)      # n[j][a]
    neff_m = np.zeros(L, dtype=np.float32)
    onehot = np.eye(24, dtype=np.int64)
    # the weights and Neff change only at the columns where the set of
    # sequences with a residue changes; in between, the previous column's
    # are kept.  w[i] holds the weights in force at column i.
    inside = X < ANY                                       # (S, L)
    before = np.zeros_like(inside)
    before[:, 1:] = inside[:, :-1]
    changes = np.nonzero((inside != before).any(axis=0))[0]
    if len(changes) == 0 or changes[0] != 0:
        raise ValueError("compute_context_weights: no sequence has a "
                         "residue in the first column")
    w = np.empty((L, set_size), dtype=np.float32)
    in_sub = np.zeros(set_size, dtype=bool)
    for ci, i in enumerate(changes.tolist()):
        new_in = inside[:, i]
        for k in np.nonzero(new_in != in_sub)[0]:
            sign = 1 if new_in[k] else -1
            n += sign * onehot[X[k].astype(np.int64)]
        in_sub = new_in
        nseqi = int(in_sub.sum())

        wi = np.full(set_size, 1e-8, dtype=np.float32)
        jmin = 0
        while jmin < L and n[jmin, ENDGAP] > MAXENDGAPFRAC * nseqi:
            jmin += 1
        jmax = L - 1
        while jmax >= 0 and n[jmax, ENDGAP] > MAXENDGAPFRAC * nseqi:
            jmax -= 1
        ncol = jmax - jmin + 1
        if ncol < NCOLMIN:
            wi = np.where(X[:, i] < ANY, wg, np.float32(0.0)).astype(np.float32)
        else:
            from ..native import w_contrib_rcp
            sub = n[jmin:jmax + 1, :ANY]
            naa = (sub > 0).sum(axis=1).astype(np.int32)
            # hardware rcp+NR, exactly as the reference's SIMD path
            w_pad = w_contrib_rcp(n[jmin:jmax + 1].astype(np.int32), naa)
            members = np.nonzero(in_sub)[0]
            seg = X[members, jmin:jmax + 1].astype(np.int64)
            contrib = w_pad[np.arange(ncol)[None, :], seg]  # (M, ncol)
            # sequential f32 accumulation over columns (the reference's
            # innermost j loop, PSSMCalculator.cpp:522-528): a cumsum
            # adds in column order
            acc = np.empty((len(members), ncol + 1), dtype=np.float32)
            acc[:, 0] = np.float32(1e-8)
            acc[:, 1:] = contrib
            wi_m = np.cumsum(acc, axis=1, dtype=np.float32)[:, -1]
            wi = np.full(set_size, 1e-8, dtype=np.float32)
            wi[members] = wi_m

        # Neff over the subalignment columns
        if ncol > 0:
            f = np.zeros((ncol, NAA), dtype=np.float32)
            members = np.nonzero(in_sub)[0]
            seg = X[members, jmin:jmax + 1].astype(np.int64)
            for a in range(NAA):
                f[:, a] = ((seg == a)
                           * wi[members][:, None]).sum(axis=0,
                                                       dtype=np.float32)
            sums = f.sum(axis=1, dtype=np.float32)
            nonzero = sums != 0
            f[nonzero] = (f[nonzero]
                          * (np.float32(1.0) / sums[nonzero])[:, None])
            ent = np.where(f > 1e-10, -f * flog2(f), np.float32(0.0))
            neff_val = ent.sum(dtype=np.float32)
            neff_m[i] = fpow2(np.float32(neff_val / ncol))[0]
        else:
            neff_m[i] = 1.0
        end = changes[ci + 1] if ci + 1 < len(changes) else L
        w[i:end] = wi
        neff_m[i + 1:end] = neff_m[i]

    # match weights: a column's weights summed per residue in f32, in
    # sequence order (the reference's loop over k), then NormalizeTo1
    col = np.minimum(X.astype(np.int64), NAA + 3)
    mw = np.zeros((L, NAA + 4), dtype=np.float32)
    rows = np.arange(L)
    for k in range(set_size):
        mw[rows, col[k]] += w[:, k]
    match_weight = np.ascontiguousarray(mw[:, :NAA])
    s = match_weight.sum(axis=1, dtype=np.float32)
    nz = s != np.float32(0.0)
    match_weight[nz] = (match_weight[nz]
                        * (np.float32(1.0) / s[nz])[:, None]).astype(
                            np.float32)
    return match_weight, neff_m


def global_aa_bias_correction(pssm: np.ndarray, p_back: np.ndarray
                              ) -> np.ndarray:
    """SubstitutionMatrix::calcGlobalAaBiasCorrection
    (SubstitutionMatrix.cpp:205-243): sequential in-place windowed
    correction of the int8 PSSM; earlier rows feed later windows in their
    already-corrected form.  The window loop runs natively
    (native/profile_native.cpp), in float32 in the JAX package's order."""
    from ..native import global_aa_bias_correction as _native
    p_null = (pssm.astype(np.float32)
              * p_back[None, :NAA].astype(np.float32)).sum(axis=1,
                                                           dtype=np.float32)
    return _native(pssm, p_null)


def compute_pssm(query: np.ndarray, targets: list[np.ndarray],
                 records: list[AlnRecord],
                 matrix: SubstitutionMatrix | None = None,
                 pca: float = 1.1, pcb: float = 4.1,
                 score_bias: float = 0.0,
                 comp_bias_correction: bool = True,
                 mask_profile: bool = True) -> Profile:
    """Full result2profile PSSM chain (default wg=0, substitution
    pseudocounts)."""
    matrix = matrix or load_substitution_matrix()
    msa = compute_msa(query, targets, records)
    set_size, L = msa.shape

    seq_weight = compute_sequence_weights(msa)
    seq_weight = normalize_to_1(seq_weight)
    match_weight, neff_m = compute_context_weights(msa, seq_weight)

    # consensus (computeConsensusSequence)
    p_back = matrix.p_back[:NAA].astype(np.float32)
    diff = match_weight - p_back[None, :]
    maxw = diff.max(axis=1)
    consensus = np.where(maxw > 1e-8, diff.argmax(axis=1), ANY).astype(np.uint8)

    # substitution pseudocounts
    R = _pseudocount_matrix(matrix)[:NAA, :NAA]
    pc = match_weight @ R.T                    # ScalarProd20(R[aa], freq)
    tau = np.minimum(np.float32(1.0),
                     np.float32(pca) / (np.float32(1.0)
                                        + neff_m / np.float32(pcb)))
    profile = ((np.float32(1.0) - tau)[:, None] * match_weight
               + tau[:, None] * pc).astype(np.float32)

    # log PSSM (computeLogPSSM, bitFactor 8.0)
    log_odds = flog2((profile / p_back[None, :]).astype(np.float32))
    val = np.float32(8.0) * log_odds + np.float32(8.0) * np.float32(score_bias)
    val = np.where(val < 0.0, val - 0.5, val + 0.5)
    pssm = np.clip(val.astype(np.float64), -128, 127)
    pssm = pssm.astype(np.int8)
    if comp_bias_correction:
        pssm = global_aa_bias_correction(pssm, matrix.p_back.astype(np.float32))
    if mask_profile:
        # Masker::maskPssm (Masker.cpp:57-80): tantan-masked positions
        # (and pre-existing X residues) get -1 for every amino acid
        from ..native import tantan_mask
        ratio = matrix.prob / (matrix.p_back[:, None] * matrix.p_back[None, :])
        masked = tantan_mask(query.astype(np.uint8), ratio, ANY)
        pssm[masked == ANY] = -1

    return Profile(pssm=pssm, probs=profile, neff_m=neff_m,
                   consensus=consensus, query=query.astype(np.uint8))
