"""MSA diversity filter (MsaFilter equivalent).

Faithful port of the hhblits-style filter used by result2profile
(lib/mmseqs/src/alignment/MsaFilter.cpp:68-555): coverage / query-identity
/ query-score prefilters followed by a greedy position-dependent
max-pairwise-identity pass over sequences sorted by residue count.

The pairwise difference counts replicate the reference's 32-byte SIMD
block semantics (MsaFilter.cpp:440-490): counting runs over whole blocks
covering [first_kj, last_kj], with the block-overhang coverage
correction, so results are bit-identical on GAP-padded rows.
"""

from __future__ import annotations

import numpy as np

from .profile import NAA, ANY, GAP

BLOCK = 32  # VECSIZE_INT * 4 with AVX2


def filter_msa(msa: np.ndarray,
               coverage: int = 0,
               qid: int = 0,
               qsc: float = -20.0,
               max_seqid: int = 90,
               ndiff: int = 1000,
               filter_min_enable: int = 0,
               sub_int: np.ndarray | None = None) -> np.ndarray:
    """Returns the keep mask (bool, per MSA row; row 0 = query always kept).

    `msa` is the (setSize, L) residue-code matrix (GAP=21). `qid` /
    `max_seqid` are integer percents, `coverage` integer percent.
    """
    n_in, L = msa.shape
    keep = np.zeros(n_in, dtype=np.int8)
    if filter_min_enable > 0 and n_in < filter_min_enable:
        keep[:] = 1
        keep[0] = 2
        return keep != 0

    # pad rows to BLOCK multiple with GAP for the blockwise counting
    Lp = ((L + BLOCK - 1) // BLOCK) * BLOCK
    X = np.full((n_in, Lp), GAP, dtype=np.int8)
    X[:, :L] = msa

    keep[0] = 2
    keep[1:] = 1
    is_aa = X < NAA

    first = np.argmax(is_aa, axis=1)
    last_rev = np.argmax(is_aa[:, ::-1], axis=1)
    last = Lp - 1 - last_rev
    no_res = ~is_aa.any(axis=1)
    first[no_res] = Lp
    last[no_res] = 0
    nres = is_aa.sum(axis=1)
    keep[nres == 0] = 0

    # stable sort rows 1.. by nres desc (MsaFilter.cpp:212-228)
    order = np.concatenate(([0], 1 + np.argsort(-nres[1:], kind="stable")))

    N = np.zeros(L, dtype=np.int64)
    N[first[0]:min(last[0], L - 1) + 1] = 1
    Nmax = np.zeros(L, dtype=np.int64)
    idmaxwin = np.full(L, -1, dtype=np.int64)
    seqid_prev = np.full(n_in, -1, dtype=np.int64)

    seqid1 = 20
    diff_nmax = ndiff
    if ndiff <= 0 or ndiff >= n_in:
        seqid1 = max_seqid
        ndiff = n_in
        diff_nmax = ndiff

    # coverage / qid / qsc prefilters (MsaFilter.cpp:255-320)
    qdiff_max_frac = 0.9999 - 0.01 * qid
    for k in range(1, n_in):
        if keep[k] == 0:
            continue
        if 100 * nres[k] < coverage * L:
            keep[k] = 0
            continue
        if qsc > -10 and sub_int is not None:
            qsc_min = qsc * nres[k]
            s = np.float32(0.0)
            gapq = gapk = 0
            for i in range(first[k], last[k] + 1):
                xk = X[k, i]
                x0 = X[0, i]
                if xk < NAA:
                    gapk = 0
                    if x0 < NAA:
                        gapq = 0
                        s = np.float32(s + sub_int[x0, xk])
                    elif x0 == ANY:
                        continue
                    else:
                        s = np.float32(s - (1.0 if gapq else 6.0))
                        gapq += 1
                elif xk == ANY:
                    continue
                elif x0 < NAA:
                    gapq = 0
                    s = np.float32(s - (1.0 if gapk else 6.0))
                    gapk += 1
            if s < qsc_min:
                keep[k] = 0
                continue
        if qdiff_max_frac < 0.999:
            qdiff_max = int(qdiff_max_frac * nres[k] + 0.9999)
            seg = slice(first[k], last[k] + 1)
            diff = int(((X[k, seg] < NAA)
                        & (X[k, seg] != X[0, seg])).sum())
            if diff >= qdiff_max:
                keep[k] = 0
                continue

    if not (keep > 0).any():
        for k in range(n_in):
            keep[k] = 1
            break

    if seqid1 > max_seqid:
        return keep != 0

    in_flag = (keep == 2).astype(np.int8)
    inkk = in_flag[order].copy()
    WFIL = 25

    # column i's window [jlo, jhi) of N, as offsets from jlo
    cols = np.arange(L)
    jlo = np.maximum(0, np.minimum(L - 2 * WFIL + 1, cols - WFIL))
    jhi = np.minimum(L, np.maximum(2 * WFIL, cols + WFIL))
    width = int((jhi - jlo).max()) if L else 0
    in_win = jlo[:, None] + np.arange(width)[None, :]
    valid = in_win < jhi[:, None]
    in_win = np.minimum(in_win, max(L - 1, 0))

    seqid = seqid1
    seqid_step = 0
    diff_nmax_prev = 0
    while seqid <= max_seqid:
        diff_nmax_prev = diff_nmax
        # the window maxima of N (0 for an empty window); N is fixed while
        # the columns are visited, so they are independent of one another
        m = np.where(valid, N[in_win], 0).max(axis=1) if L else N
        np.maximum(Nmax, m, out=Nmax)
        short = Nmax < ndiff
        if not short.any():
            break
        idmaxwin[short] = seqid
        diff_nmax = max(0, int((ndiff - Nmax[short]).max()))

        for kk in range(n_in):
            if inkk[kk]:
                continue
            k = order[kk]
            if keep[k] == 0:
                continue
            if keep[k] == 2:
                inkk[kk] = 2
                continue
            if seqid >= 100:
                in_flag[k] = inkk[kk] = 1
                continue

            seqidk = float(seqid1)
            if last[k] >= first[k]:
                lo, hi = first[k], min(last[k], L - 1) + 1
                if hi > lo:
                    seqidk = max(seqidk, float(idmaxwin[lo:hi].max()))
            if seqid == seqid_prev[k]:
                continue
            seqid_prev[k] = seqid
            diff_min_frac = 0.9999 - 0.01 * seqidk

            accepted = True
            for jj in range(kk):
                if not inkk[jj]:
                    continue
                j = order[jj]
                first_kj = max(first[k], first[j])
                last_kj = min(last[k], last[j])
                cov_kj = last_kj - first_kj + 1
                diff_suff = int(diff_min_frac * min(nres[k], cov_kj) + 0.999)
                blo = (first_kj // BLOCK) * BLOCK
                bhi = (last_kj // BLOCK + 1) * BLOCK
                cov_kj += abs(blo - first_kj) + abs(bhi - (last_kj + 1))
                xk = X[k, blo:bhi]
                xj = X[j, blo:bhi]
                no_aa = (xk >= NAA) | (xj >= NAA)
                cov_kj -= int(no_aa.sum())
                diff = int((~((xk == xj) | no_aa)).sum())
                if diff < diff_suff and diff <= diff_min_frac * cov_kj and cov_kj > 0:
                    accepted = False
                    break
            if accepted:
                in_flag[k] = inkk[kk] = 1
                lo, hi = first[k], min(last[k], L - 1) + 1
                N[lo:hi] += 1

        seqid_step = max(1, min(5, diff_nmax
                                // (diff_nmax_prev - diff_nmax + 1)
                                * seqid_step // 2))
        seqid += seqid_step

    out = in_flag.copy()
    out[keep == 0] = 0
    return out != 0
