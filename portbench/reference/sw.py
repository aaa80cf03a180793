"""Plain PyTorch Smith-Waterman with affine gaps: the reference for the
SW results of the pairs a job aligned.

One cell (Gotoh, local):

    E(i, j) = max(E(i, j-1) - extend, H(i, j-1) - open)
    F(i, j) = max(F(i-1, j) - extend, H(i-1, j) - open)
    H(i, j) = max(0, H(i-1, j-1) + s(i, j), E(i, j), F(i, j))

so a gap of length L costs open + (L - 1) extend.  s(i, j) is the query
position's profile row at the target token: int8(sub[q_i, t_j] + bias_i)
(wrapping, as MMseqs2's int8 profile does), plus, for the structure
search, a second channel int8(sub2[q2_i, t2_j]).

`forward` gives per pair the score (the largest H, at least 0) and its end
point: the first target column whose column maximum exceeds every earlier
one, and the first query row that reaches it there.  `reverse` scans the
flipped prefixes q[0..q_end], t[0..t_end] for the first column whose
maximum equals the forward score and the first row reaching it, which
gives the start point (q_end - row, t_end - column).

The DP runs in int32 and is exact for every score these sets give.
`saturate=8` clamps every DP value into int8's range after each step: the
control of the comparison (an SW computed in the precision below the
16-bit one that MMseqs2 and Foldseek align in).

The scan runs over target columns, vectorized over (pairs, query rows);
F, the gap along the query, is the closed form of a running maximum.
Pairs go in batches of similar target length, each bounded by
`cells` pairs x query rows.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 29)


def _batches(qlens: np.ndarray, tlens: np.ndarray, cells: int):
    order = np.lexsort((qlens, tlens))
    s = 0
    n = len(order)
    while s < n:
        qmax = np.maximum.accumulate(qlens[order[s:]])
        fits = np.arange(1, n - s + 1) * np.maximum(qmax, 1) <= cells
        e = s + max(int(fits.sum()), 1)
        yield order[s:e]
        s = e


def _pad(seqs, idx, length, dtype=np.int64) -> np.ndarray:
    out = np.zeros((len(idx), length), dtype=dtype)
    for r, k in enumerate(idx):
        s = seqs[k]
        out[r, :len(s)] = s
    return out


def _scan(prof, t, prof2, t2, qlens, tlens, gap_open, gap_extend,
          terminate, saturate):
    """prof (B, A, Lq) int32, t (B, Lt) tokens; returns (score, t_end,
    q_end, found, fj, fi) as int64 numpy arrays."""
    B, A, Lq = prof.shape
    Lt = t.shape[1]
    dev = prof.device
    i32 = torch.int32
    rows = torch.arange(Lq, device=dev, dtype=i32)[None, :]
    valid = rows < qlens[:, None]
    bidx = torch.arange(B, device=dev)
    lo, hi = ((-(1 << (saturate - 1)), (1 << (saturate - 1)) - 1)
              if saturate else (None, None))
    ramp = gap_extend * rows
    f_off = gap_open + gap_extend * (rows - 1)
    H = torch.zeros((B, Lq), device=dev, dtype=i32)
    E = torch.full((B, Lq), NEG, device=dev, dtype=i32)
    best = torch.zeros(B, device=dev, dtype=i32)
    bj = torch.full((B,), -1, device=dev, dtype=i32)
    bi = torch.zeros(B, device=dev, dtype=i32)
    found = torch.zeros(B, device=dev, dtype=torch.bool)
    fj = torch.full((B,), -1, device=dev, dtype=i32)
    fi = torch.zeros(B, device=dev, dtype=i32)
    first_neg = torch.full((B, 1), NEG, device=dev, dtype=i32)
    zero = torch.zeros((B, 1), device=dev, dtype=i32)
    for j in range(Lt):
        s = prof[bidx, t[:, j]]
        if prof2 is not None:
            s = s + prof2[bidx, t2[:, j]]
        diag = torch.cat([zero, H[:, :-1]], dim=1)
        E = torch.maximum(E - gap_extend, H - gap_open)
        if saturate:
            E = E.clamp(lo, hi)
        Hb = torch.maximum(torch.maximum(diag + s, E), torch.zeros_like(E))
        if saturate:
            Hb = Hb.clamp(lo, hi)
        up = torch.cat([first_neg, (Hb + ramp)[:, :-1]], dim=1)
        F = torch.cummax(up, dim=1).values - f_off
        H = torch.where(valid, torch.maximum(Hb, F), 0)
        if saturate:
            H = H.clamp(lo, hi)
        cmax = torch.where(valid, H, -1).max(dim=1).values
        first = torch.where(valid & (H == cmax[:, None]), rows,
                            Lq).min(dim=1).values
        live = j < tlens
        up_best = live & (cmax > best)
        best = torch.where(up_best, cmax, best)
        bj = torch.where(up_best, j, bj)
        bi = torch.where(up_best, first, bi)
        hit = live & ~found & (cmax == terminate)
        fj = torch.where(hit, j, fj)
        fi = torch.where(hit, first, fi)
        found = found | hit
    return tuple(x.cpu().numpy().astype(np.int64)
                 for x in (best, bj, bi, found, fj, fi))


class Pairs:
    """The pairs to align, as per-pair numpy token arrays: query tokens
    q, its bias qb (int8), target tokens t; for the structure search a
    second channel q2 / t2.  sub (and sub2) are the integer tables."""

    def __init__(self, q, qb, t, sub, q2=None, t2=None, sub2=None):
        self.q, self.qb, self.t = q, qb, t
        self.q2, self.t2 = q2, t2
        self.sub = np.asarray(sub, dtype=np.int64)
        self.sub2 = None if sub2 is None else np.asarray(sub2, np.int64)

    def __len__(self) -> int:
        return len(self.q)


def _profile(sub, q, qb, qlens, Lq):
    """(B, A, Lq) int32: int8(sub[q_i, a] + qb_i), 0 past qlen."""
    prof = sub[q]                                     # (B, Lq, A)
    if qb is not None:
        prof = prof + qb[:, :, None]
    prof = prof.astype(np.int8).astype(np.int32)      # the int8 wrap
    prof[np.arange(Lq)[None, :] >= qlens[:, None]] = 0
    return np.ascontiguousarray(prof.transpose(0, 2, 1))


def align(pairs: Pairs, gap_open: int, gap_extend: int, device,
          saturate: int | None = None, cells: int = 1 << 22) -> dict:
    """Forward and reverse passes of every pair; returns int64 arrays
    score, q_start, q_end, t_start, t_end (-1 where the score is 0)."""
    n = len(pairs)
    qlens = np.array([len(x) for x in pairs.q], dtype=np.int64)
    tlens = np.array([len(x) for x in pairs.t], dtype=np.int64)
    out = {k: np.full(n, -1, dtype=np.int64)
           for k in ("score", "q_start", "q_end", "t_start", "t_end")}
    dev = torch.device(device)

    def run(idx, q, qb, t, q2, t2, ql, tl, term):
        Lq, Lt = max(int(ql.max()), 1), max(int(tl.max()), 1)
        prof = _profile(pairs.sub, _pad(q, range(len(idx)), Lq),
                        _pad(qb, range(len(idx)), Lq), ql, Lq)
        prof2 = tt2 = None
        if pairs.sub2 is not None:
            prof2 = torch.from_numpy(_profile(
                pairs.sub2, _pad(q2, range(len(idx)), Lq), None, ql,
                Lq)).to(dev)
            tt2 = torch.from_numpy(_pad(t2, range(len(idx)), Lt)).to(dev)
        return _scan(torch.from_numpy(prof).to(dev),
                     torch.from_numpy(_pad(t, range(len(idx)), Lt)).to(dev),
                     prof2, tt2,
                     torch.from_numpy(ql).to(dev, torch.int32),
                     torch.from_numpy(tl).to(dev, torch.int32),
                     gap_open, gap_extend,
                     torch.from_numpy(term).to(dev, torch.int32), saturate)

    def sel(seqs, idx):
        return None if seqs is None else [seqs[k] for k in idx]

    for idx in _batches(qlens, tlens, cells):
        score, te, qe, _f, _fj, _fi = run(
            idx, sel(pairs.q, idx), sel(pairs.qb, idx), sel(pairs.t, idx),
            sel(pairs.q2, idx), sel(pairs.t2, idx), qlens[idx], tlens[idx],
            np.full(len(idx), -1, dtype=np.int64))
        out["score"][idx] = score
        out["q_end"][idx] = np.where(score > 0, qe, -1)
        out["t_end"][idx] = np.where(score > 0, te, -1)

    # reverse: flipped prefixes up to the end point, terminate = score
    live = np.nonzero(out["score"] > 0)[0]
    qe, te = out["q_end"][live], out["t_end"][live]

    def flip(seqs, ends):
        return None if seqs is None else [
            seqs[k][:e + 1][::-1] for k, e in zip(live, ends)]

    rq, rqb, rt = flip(pairs.q, qe), flip(pairs.qb, qe), flip(pairs.t, te)
    rq2, rt2 = flip(pairs.q2, qe), flip(pairs.t2, te)
    for idx in _batches(qe + 1, te + 1, cells):
        _s, _te, _qe, found, fj, fi = run(
            idx, sel(rq, idx), sel(rqb, idx), sel(rt, idx), sel(rq2, idx),
            sel(rt2, idx), qe[idx] + 1, te[idx] + 1,
            out["score"][live[idx]])
        k = live[idx]
        out["q_start"][k] = np.where(found > 0, qe[idx] - fi, -1)
        out["t_start"][k] = np.where(found > 0, te[idx] - fj, -1)
    return out
