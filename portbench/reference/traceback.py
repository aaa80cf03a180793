"""Plain PyTorch banded traceback: the reference for the CIGAR, alignment
length and identity of the records a job wrote.

MMseqs2 (and Foldseek) trace a local alignment once its score and its
start and end points are known: `banded_sw` of StripedSmithWaterman.cpp
re-runs the affine-gap DP inside the rectangle q[q_start..q_end] x
t[t_start..t_end], in a band of half-width w = |t_len - q_len| + 1 about
the main diagonal (doubled until the band reaches the score), and walks
its direction matrix back from the rectangle's far corner.  This file
does the same, in the same buffers, so that its walk takes the same turns:

  * row i covers columns max(0, i - w) .. min(t_len - 1, i + w); the row
    buffers h_b (H of the row before), e_b (E) are 2w + 5 wide, indexed
    u = j - max(i - w, 0) + 1; at a row's start h_b[0], e_b[0] and
    h_b[edge], e_b[edge] (edge = min(end + 1, 2w + 2)) are zeroed, and a
    row writes back only its own columns, as the original does;
  * E(i, j) = max(H(i-1, j) - open, E(i-1, j) - extend), 'I' (a query
    residue against a gap), the open on strict >; row 0 reads -open,
    -extend;
  * F(i, j) = max(H(i, j-1) - open, F(i, j-1) - extend), 'D', the open on
    strict >, F = 0 and H = 0 before a row's first column;
  * H(i, j) = max(max(E, 0), max(F, 0), H(i-1, j-1) + s(i, j)): the
    diagonal on ties, else E where max(E, 0) > max(F, 0), else F;
  * the walk starts in H at (q_len - 1, t_len - 1), stops at (0, 0) and
    ends on an 'M'.

The cell s(i, j): the sequence search's sub[q_i, t_j] + bias_i (no wrap);
the structure search's profile entry int8(mat3di[q_i, t_j] + bias_i +
aa[q2_i, t2_j]).  The recurrence along a row, F, is taken in closed form
(a running maximum, exact for open >= extend), and each direction bit
from the exact values on both sides of its comparison.  The rows run one
after another, vectorized over pairs and over each pair's next LEVELS
bands (the first that reaches the score is the one the original keeps);
the walks in step, over pairs.
"""

from __future__ import annotations

from itertools import groupby

import numpy as np
import torch

OPS = np.array(list("?MIIDD"))
LEVELS = 4          # bands a pair tries in one pass of rows


def cigar(ops: str) -> str:
    """Run-length encoding of an expanded op string (Matcher::
    compressAlignment)."""
    return "".join(f"{len(list(g))}{c}" for c, g in groupby(ops))


def _batches(qlen, count, wd_max, cells: int):
    """Pairs in groups of similar query length (a batch runs as many rows
    as its longest), each group's entries (a pair's bands) holding at most
    `cells` direction cells (a lone pair may hold more)."""
    order = np.argsort(qlen, kind="stable")
    s, n = 0, len(order)
    while s < n:
        e = s + 1
        ql, wd, m = qlen[order[s]], wd_max[order[s]], count[order[s]]
        while e < n:
            ql = max(ql, qlen[order[e]])
            wd = max(wd, wd_max[order[e]])
            if (m + count[order[e]]) * ql * wd * 3 > cells:
                break
            m += count[order[e]]
            e += 1
        yield order[s:e]
        s = e


def _pad(seqs, length: int, dev, dtype=torch.int64) -> torch.Tensor:
    out = np.zeros((len(seqs), max(length, 1)), dtype=np.int64)
    for r, s in enumerate(seqs):
        out[r, :len(s)] = s
    return torch.from_numpy(out).to(dev, dtype)


def _band_dp(qtok, qb, ttok, q2, t2, sub, sub2, ql, tl, w, gap_open,
             gap_extend, dev):
    """One pass of the banded DP over a batch.  Returns (direction
    (P, Lq * Wd * 3 + 1) int8, each pair's in the original's flat layout
    with its own Wd = 2w + 1, the largest H of each pair)."""
    P = len(ql)
    Lq = int(ql.max())
    wd = 2 * w + 1                              # direction columns a row
    width = 2 * w + 3
    WB = int(width.max()) + 2
    K = int(wd.max())
    o, x = gap_open, gap_extend
    i64 = torch.int64
    h_b = torch.zeros((P, WB), device=dev, dtype=i64)
    e_b = torch.zeros((P, WB), device=dev, dtype=i64)
    scratch = Lq * K * 3
    direc = torch.zeros((P, scratch + 1), device=dev, dtype=torch.int8)
    max_h = torch.zeros(P, device=dev, dtype=i64)
    pidx = torch.arange(P, device=dev)
    k = torch.arange(K, device=dev, dtype=i64)[None, :]
    kprev = k - 1
    c3 = torch.arange(3, device=dev, dtype=i64)
    for i in range(Lq):
        act = i < ql
        xi = (i - w).clamp(min=0)
        xp = (i - 1 - w).clamp(min=0)
        end = torch.minimum(tl - 1, i + w)
        n = torch.where(act, end - xi + 1, 0)
        edge = torch.minimum(end + 1, width - 1).clamp(max=WB - 1)
        h_b[:, 0] = 0
        e_b[:, 0] = 0
        h_b[pidx, edge] = torch.where(act, 0, h_b[pidx, edge])
        e_b[pidx, edge] = torch.where(act, 0, e_b[pidx, edge])
        valid = k < n[:, None]
        e_idx = (k + 1 + (xi - xp)[:, None]).clamp(max=WB - 1)
        d_idx = e_idx - 1
        j = (xi[:, None] + k).clamp(max=ttok.shape[1] - 1)
        if i == 0:
            t1 = torch.full((P, K), -o, device=dev, dtype=i64)
            t2_ = torch.full((P, K), -x, device=dev, dtype=i64)
        else:
            t1 = h_b.gather(1, e_idx) - o
            t2_ = e_b.gather(1, e_idx) - x
        E = torch.maximum(t1, t2_)
        de = torch.where(t1 > t2_, 3, 2)
        qi = qtok[:, min(i, qtok.shape[1] - 1)]
        s = sub[qi[:, None], ttok.gather(1, j)] \
            + qb[:, min(i, qb.shape[1] - 1)][:, None]
        if sub2 is not None:
            q2i = q2[:, min(i, q2.shape[1] - 1)]
            s = s + sub2[q2i[:, None], t2.gather(1, j)]
            s = (s + 128) % 256 - 128                   # the int8 profile
        e1 = E.clamp(min=0)
        diag = h_b.gather(1, d_idx) + s
        A = torch.maximum(e1, diag)
        # F_k = max over m in -1..k-1 of A_m - open - (k-1-m) extend, and
        # -(k+1) extend; A_-1 = 0
        G = torch.where(valid, A + k * x, torch.iinfo(i64).min // 4)
        run = torch.cummax(G, dim=1).values
        run_prev = torch.cat([torch.full((P, 1), -x, device=dev, dtype=i64),
                              torch.maximum(run[:, :-1],
                                            torch.tensor(-x, device=dev))],
                             dim=1)
        F = torch.maximum(run_prev - o - kprev * x, -(k + 1) * x)
        H = torch.maximum(A, F)
        h_prev = torch.cat([torch.zeros((P, 1), device=dev, dtype=i64),
                            H[:, :-1]], dim=1)
        f_prev = torch.cat([torch.zeros((P, 1), device=dev, dtype=i64),
                            F[:, :-1]], dim=1)
        df = torch.where(h_prev - o > f_prev - x, 5, 4)
        f1 = F.clamp(min=0)
        dh = torch.where(torch.maximum(e1, f1) <= diag, 1,
                         torch.where(e1 > f1, de, df))
        max_h = torch.maximum(max_h, torch.where(valid, H, 0).max(dim=1)
                              .values)
        # writes: the row's own columns; the rest go to a scratch column
        # (WB - 1) and a scratch direction cell (the last), never read
        u_w = torch.where(valid, k + 1, WB - 1)
        e_b.scatter_(1, u_w, E)
        h_b.scatter_(1, u_w, H)
        flat = (wd * 3 * i)[:, None, None] + k[:, :, None] * 3 + c3
        flat = torch.where(valid[:, :, None], flat, scratch)
        direc.scatter_(1, flat.reshape(P, -1),
                       torch.stack([de, df, dh], dim=2).to(torch.int8)
                       .reshape(P, -1))
    return direc, max_h


def _walk(direc, ql, tl, w, dev):
    """The walks back from each pair's far corner: (ops (P, S) int8 codes
    1-5 in walk order, their count, failed)."""
    P = len(ql)
    wd3 = (2 * w + 1) * 3
    size = wd3 * ql
    i, j = ql - 1, tl - 1
    st = torch.full((P,), 2, device=dev, dtype=torch.int64)
    line = wd3 * (ql - 1)
    steps = int((ql + tl).max()) + 2
    ops = torch.zeros((P, steps), device=dev, dtype=torch.int8)
    count = torch.zeros(P, device=dev, dtype=torch.int64)
    failed = torch.zeros(P, device=dev, dtype=torch.bool)
    for step in range(steps):
        live = ((i > 0) | (j > 0)) & ~failed
        if not bool(live.any()):
            break
        flat = line + (j - (i - w).clamp(min=0)) * 3 + st
        bad = live & ((flat < 0) | (flat >= size))
        d = direc.gather(1, flat.clamp(0, direc.shape[1] - 1)[:, None])[:, 0]
        d = d.to(torch.int64)
        bad = bad | (live & ((d < 1) | (d > 5)))
        failed = failed | bad
        go = live & ~bad
        ops[:, step] = torch.where(go, d, 0).to(torch.int8)
        count = count + go.to(torch.int64)
        down = go & (d <= 3)                    # M, I: one query row up
        left = go & ((d == 1) | (d >= 4))       # M, D: one column left
        i = i - down.to(torch.int64)
        j = j - left.to(torch.int64)
        line = line - torch.where(down, wd3, 0)
        st = torch.where(go, torch.where((d == 2), 0,
                                         torch.where(d == 4, 1, 2)), st)
    failed = failed | (((i > 0) | (j > 0)))
    return ops, count, failed


def traceback(q, qb, t, sub, rect: dict, gap_open: int, gap_extend: int,
              device, q2=None, t2=None, sub2=None, ident_q=None,
              ident_t=None, cells: int = 1 << 31):
    """The banded traceback of every pair in its rectangle.

    q, qb, t (and q2, t2): per-pair whole token arrays (numpy), sub
    (sub2): integer tables; rect: int64 arrays q_start, q_end, t_start,
    t_end, score (the raw SW score the band has to reach).  ident_q /
    ident_t: the tokens whose equality in an M column is an identity
    (default q, t).  Returns (ops strings, None where the walk fails,
    identity counts).  A batch holds up to `cells` int8 direction cells
    (2 GiB by default): its rows cost the same launches at any width, so
    long pairs go together rather than a few to a batch (on an H100, 272
    traced pairs of a job rich in 1,500-6,000 aa genes took 21 s where
    2**28 took 93).
    The batches change no pair's result."""
    n = len(q)
    dev = torch.device(device)
    ident_q = q if ident_q is None else ident_q
    ident_t = t if ident_t is None else ident_t
    qs, qe = rect["q_start"], rect["q_end"]
    ts, te = rect["t_start"], rect["t_end"]
    ql = (qe - qs + 1).astype(np.int64)
    tl = (te - ts + 1).astype(np.int64)
    w = np.abs(ql - tl) + 1
    out: list = [None] * n
    idents = np.zeros(n, dtype=np.int64)
    sub_t = torch.from_numpy(np.asarray(sub, np.int64)).to(dev)
    sub2_t = (None if sub2 is None
              else torch.from_numpy(np.asarray(sub2, np.int64)).to(dev))
    level = np.zeros(n, dtype=np.int64)      # the next band to try
    limit = 2 * (ql + tl) + 8
    todo = np.arange(n)
    while len(todo):
        # each pair's next LEVELS bands (w, 2w, 4w, ...) side by side, so
        # that one pass of rows finds the band the original stops at
        bands = {}
        for p in todo:
            ks = [k for k in range(level[p], level[p] + LEVELS)
                  if k == 0 or (w[p] << k) <= limit[p]]
            bands[p] = ks
        cnt = np.array([len(bands[p]) for p in todo])
        wmax = np.array([2 * (w[p] << bands[p][-1]) + 1 for p in todo])
        retry = []
        for bi in _batches(ql[todo], cnt, wmax, cells):
            pairs = todo[bi]
            ep = np.array([p for p in pairs for _k in bands[p]])
            ek = np.array([k for p in pairs for k in bands[p]])
            ew = w[ep] << ek

            def seg(seqs, a, b):
                return [seqs[p][a[p]:b[p] + 1] for p in ep]

            qt = _pad(seg(q, qs, qe), int(ql[ep].max()), dev)
            bt = _pad(seg(qb, qs, qe), int(ql[ep].max()), dev)
            tt = _pad(seg(t, ts, te), int(tl[ep].max()), dev)
            q2t = t2t = None
            if sub2 is not None:
                q2t = _pad(seg(q2, qs, qe), int(ql[ep].max()), dev)
                t2t = _pad(seg(t2, ts, te), int(tl[ep].max()), dev)
            qlt = torch.from_numpy(ql[ep]).to(dev)
            tlt = torch.from_numpy(tl[ep]).to(dev)
            wt = torch.from_numpy(ew).to(dev)
            direc, max_h = _band_dp(qt, bt, tt, q2t, t2t, sub_t, sub2_t,
                                    qlt, tlt, wt, gap_open, gap_extend, dev)
            reached = max_h.cpu().numpy() >= rect["score"][ep]
            chosen = []                  # (entry row, pair)
            for p in pairs:
                rows = np.nonzero(ep == p)[0]
                hit = rows[reached[rows]]
                if len(hit):
                    chosen.append((int(hit[0]), p))
                elif (bands[p][-1] + 1 == bands[p][0] + LEVELS
                      and (w[p] << (bands[p][-1] + 1)) <= limit[p]):
                    level[p] = bands[p][-1] + 1
                    retry.append(p)      # else the original gives up
            if not chosen:
                continue
            sel = torch.tensor([r for r, _p in chosen], device=dev)
            ops, count, failed = _walk(direc[sel], qlt[sel], tlt[sel],
                                       wt[sel], dev)
            del direc
            ops, count = ops.cpu().numpy(), count.cpu().numpy()
            failed = failed.cpu().numpy()
            for r, (_e, p) in enumerate(chosen):
                if failed[r]:
                    continue
                walk = "".join(OPS[ops[r, :count[r]]])[::-1]
                out[p] = "M" + walk
                b = np.frombuffer(out[p].encode(), dtype=np.uint8)
                is_m = b == ord("M")
                q_adv = is_m | (b == ord("I"))
                t_adv = is_m | (b == ord("D"))
                qp = qs[p] + np.cumsum(q_adv) - q_adv
                tp = ts[p] + np.cumsum(t_adv) - t_adv
                idents[p] = int((np.asarray(ident_q[p])[qp[is_m]]
                                 == np.asarray(ident_t[p])[tp[is_m]]).sum())
        todo = np.array(retry, dtype=np.int64)
    return out, idents
