"""Plain PyTorch Smith-Waterman: the reference versions of the CUDA kernels.

`gather_panels` is the plain counterpart of the JAX package's
`ops/sw_engine.py::panel_gather` (and of the flipped gather of the
reverse pass): it cuts per-pair (B, Lq) query-token / bias panels and
(B, Lt) target-token panels out of the resident 1-D arrays.
`make_profile` builds prof[b, a, i] = sub[q_bi, a] + bias_bi, and
`sw_scan_ref` is a line-for-line twin of the JAX package's
`ops/sw_tiled.py::sw_scan_core`: a column loop over target positions,
vectorized over (B, Lq), with the same six outputs

    (score, t_end, q_end, found, fj, fi)

  * score: max H over valid cells, clamped at 0;
  * (t_end, q_end): the first target column whose column max strictly
    exceeds the running best, then the first query row reaching it;
    (-1, 0) when the score is 0;
  * (found, fj, fi): the first column whose column max equals
    `terminate`, and the first row reaching it there; (0, -1, 0) when no
    column does.

Per-cell score: int8(sub[q_i][t_j] + bias_i) — the profile is cast to
int8 (wrapping), as the JAX scan does.  The DP runs in int32 (Gotoh with
a local 0 clamp; E carries across target columns, F is the in-column gap
in the closed form of a running max).

Structure mode (`sw_struct_jobs_ref`, the plain version of the JAX
package's `ops/sw_engine.py::_sw_bucket_struct`) adds a second channel:
`sw_scan_ref(prof2=, tseq2=)` scores a cell as
int8(prof[t_j]) + int8(prof2[t2_j]), each profile cast to int8 on its own
(3Di: m3di + the 3Di bias; amino acids: the scaled table, no bias).

Profile queries (`sw_prof_jobs_ref`, the plain version of the JAX
package's `ops/sw.py::sw_forward_from_profiles` /
`sw_reverse_from_profiles`) read each job's explicit (A, Lq) profile out
of the queries' resident int8 profile rows (PROF_COLS a residue, flipped
for the reverse pass) and score it as `sw_scan_ref` scores any profile.

These run wherever their tensors are.  The CPU tests hold them against
the JAX package; on the card they are the yardstick `chip_smoke.py`
holds the kernels of `ops/sw_cuda.py` against.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 30)
PROF_COLS = 21           # profile columns a residue: 20 amino acids and X
# (pairs x query rows) per plain-version batch: bounds the (B, A, Lq)
# profile and the (B, Lq) DP state.  On CUDA a column step's dozen small
# ops cost their launches, not their bytes, until a batch is this large.
REF_CELLS = 1 << 20
REF_CELLS_CUDA = 1 << 23


def panel_index(qoff: torch.Tensor, qlen: torch.Tensor, toff: torch.Tensor,
                tlen: torch.Tensor, Lq: int, Lt: int, reverse: bool):
    """(B, Lq) query and (B, Lt) target element indices of per-pair
    panels at the given offsets.  reverse=True reads the flipped prefixes
    q[qoff+qlen-1-i], t[toff+tlen-1-j].  Positions past a pair's length
    are clamped into the pair (the DP's validity masks make them
    unreachable)."""
    dev = qoff.device
    iq = torch.arange(Lq, device=dev, dtype=torch.int64)[None, :]
    it = torch.arange(Lt, device=dev, dtype=torch.int64)[None, :]
    ql = qlen.to(torch.int64)[:, None]
    tl = tlen.to(torch.int64)[:, None]
    if reverse:
        qsel = (ql - 1 - iq).clamp(min=0)
        tsel = (tl - 1 - it).clamp(min=0)
    else:
        qsel = torch.minimum(iq, ql - 1).clamp(min=0)
        tsel = torch.minimum(it, tl - 1).clamp(min=0)
    return (qoff.to(torch.int64)[:, None] + qsel,
            toff.to(torch.int64)[:, None] + tsel)


def gather_panels(qdata: torch.Tensor, qbias: torch.Tensor,
                  tdata: torch.Tensor, qoff: torch.Tensor, qlen: torch.Tensor,
                  toff: torch.Tensor, tlen: torch.Tensor, Lq: int, Lt: int,
                  reverse: bool):
    """(B, Lq) query tokens, (B, Lq) bias and (B, Lt) target tokens, all
    int32, read from the resident arrays at per-pair element offsets
    (panel_index)."""
    q_idx, t_idx = panel_index(qoff, qlen, toff, tlen, Lq, Lt, reverse)
    return (qdata[q_idx].to(torch.int32), qbias[q_idx].to(torch.int32),
            tdata[t_idx].to(torch.int32))


def make_profile(qtok: torch.Tensor, qb: torch.Tensor | None,
                 sub: torch.Tensor) -> torch.Tensor:
    """prof[b, a, i] = sub[q[b, i], a] + bias[b, i]  -> (B, A, Lq) int32
    (no bias term when qb is None)."""
    prof = sub.to(torch.int32)[qtok.to(torch.int64)]      # (B, Lq, A)
    if qb is not None:
        prof = prof + qb.to(torch.int32)[:, :, None]
    return prof.permute(0, 2, 1).contiguous()


def sw_scan_ref(prof: torch.Tensor, tseq: torch.Tensor, qlens: torch.Tensor,
                tlens: torch.Tensor, gap_open: int, gap_extend: int,
                terminate: torch.Tensor, prof2: torch.Tensor | None = None,
                tseq2: torch.Tensor | None = None):
    """prof: (B, A, Lq) int32; tseq: (B, Lt) int tokens; lens and
    terminate (B,); optional second channel prof2 (B, A2, Lq) / tseq2
    (B, Lt).  Returns the six int32 outputs described above.

    H and E are not frozen past a pair's tlen: those columns feed only
    later columns of the same pair, which are past tlen too, and every
    tracker update is gated on the column being valid."""
    B, A, Lq = prof.shape
    Lt = tseq.shape[1]
    dev = prof.device
    i32 = torch.int32
    iota_q = torch.arange(Lq, device=dev, dtype=i32)[None, :]
    qlens = qlens.to(i32)
    tlens = tlens.to(i32)
    terminate = terminate.to(i32)
    valid = (iota_q < qlens[:, None]).to(i32)              # (B, Lq) 0/1
    valid_m1 = valid - 1
    go = gap_open
    ge = gap_extend
    # int8 wrap, NEG on rows past qlen; rows of the flat (B*A, Lq) view
    # are picked per column by b*A + t[b, j]
    prof_i8 = prof.to(torch.int8).to(i32)
    prof_i8 = torch.where(valid[:, None, :].bool(), prof_i8, NEG)
    prof_rows = prof_i8.reshape(B * A, Lq)
    row_base = torch.arange(B, device=dev, dtype=torch.int64) * A
    tseq = tseq.to(torch.int64)
    if prof2 is not None:
        # rows past qlen already carry NEG in channel 1
        A2 = prof2.shape[1]
        prof2_rows = prof2.to(torch.int8).to(i32).reshape(B * A2, Lq)
        row_base2 = torch.arange(B, device=dev, dtype=torch.int64) * A2
        tseq2 = tseq2.to(torch.int64)
    ge_iota = ge * iota_q
    f_off = go + ge * (iota_q - 1)
    neg_col = torch.full((B, 1), NEG, device=dev, dtype=i32)
    zero_col = torch.zeros((B, 1), device=dev, dtype=i32)

    H = torch.zeros((B, Lq), device=dev, dtype=i32)
    E = torch.full((B, Lq), NEG, device=dev, dtype=i32)
    gmax = torch.zeros(B, device=dev, dtype=i32)
    gj = torch.full((B,), -1, device=dev, dtype=i32)
    gi = torch.zeros(B, device=dev, dtype=i32)
    found = torch.zeros(B, device=dev, dtype=torch.bool)
    fj = torch.full((B,), -1, device=dev, dtype=i32)
    fi = torch.zeros(B, device=dev, dtype=i32)
    for j in range(Lt):
        s_col = prof_rows.index_select(0, row_base + tseq[:, j])
        if prof2 is not None:
            s_col = s_col + prof2_rows.index_select(0, row_base2
                                                    + tseq2[:, j])
        diag = torch.cat([zero_col, H[:, :-1]], dim=1)
        E = torch.maximum(E - ge, H - go)
        Hbase = torch.maximum((diag + s_col).clamp_(min=0), E)
        shifted = torch.cat([neg_col, (Hbase + ge_iota)[:, :-1]], dim=1)
        F = torch.cummax(shifted, dim=1).values - f_off
        H = torch.maximum(Hbase, F) * valid               # 0 past qlen

        # column max over valid rows (-1 past qlen) and its first row
        cmax, ci = (H + valid_m1).max(dim=1)
        ci = ci.to(i32)
        col_valid = j < tlens
        better = col_valid & (cmax > gmax)
        gmax = torch.where(better, cmax, gmax)
        gj = torch.where(better, j, gj)
        gi = torch.where(better, ci, gi)
        hit = col_valid & ~found & (cmax == terminate)
        fj = torch.where(hit, j, fj)
        fi = torch.where(hit, ci, fi)
        found = found | hit
    return gmax, gj, gi, found.to(i32), fj, fi


def _job_batches(jobs: np.ndarray, tight: bool):
    """Index batches, each grown while B * max(qlen) fits REF_CELLS
    (REF_CELLS_CUDA when not tight).

    tight (the CPU, where the scan is compute-bound): pairs grouped by
    query length in quarter-octave buckets and ordered by target length
    within a bucket, so that a batch's (max qlen) x (max tlen) box holds
    little padding.  Otherwise (CUDA, where each target column costs a
    dozen small kernel launches, so the count of batches and columns sets
    the time): pairs ordered by their longer side, in as few batches as
    fit."""
    n = jobs.shape[1]
    limit = REF_CELLS if tight else REF_CELLS_CUDA
    if tight:
        q = np.maximum(jobs[1], 1).astype(np.int64)
        octave = np.floor(np.log2(q)).astype(np.int64)
        bucket = 4 * octave + ((q >> np.maximum(octave - 2, 0)) & 3)
        order = np.lexsort((jobs[3], bucket))
    else:
        bucket = np.zeros(n, dtype=np.int64)
        order = np.argsort(np.maximum(jobs[1], jobs[3]), kind="stable")
    s = 0
    while s < n:
        rest = order[s:]
        same = bucket[rest] == bucket[rest[0]]
        m = len(rest) if same.all() else int(np.argmin(same))
        ql = np.maximum.accumulate(jobs[1, rest[:m]])
        fits = np.arange(1, m + 1) * np.maximum(ql, 1) <= limit
        e = s + max(int(fits.sum()), 1)
        yield order[s:e]
        s = e


def _jobs_ref(dev: torch.device, jobs: np.ndarray, scan) -> torch.Tensor:
    """Run `scan(j, Lq, Lt)` (j: the batch's (5, B) jobs on dev) over
    _job_batches and scatter the six outputs into a (6, n) result."""
    out = torch.empty((6, jobs.shape[1]), dtype=torch.int32, device=dev)
    for idx in _job_batches(jobs, tight=dev.type == "cpu"):
        j = torch.from_numpy(np.ascontiguousarray(jobs[:, idx])).to(dev)
        Lq = max(int(jobs[1, idx].max()), 1)
        Lt = max(int(jobs[3, idx].max()), 1)
        out[:, torch.from_numpy(idx).to(dev)] = torch.stack(scan(j, Lq, Lt))
    return out


def sw_jobs_ref(qdata: torch.Tensor, qbias: torch.Tensor,
                tdata: torch.Tensor, sub: torch.Tensor, jobs: np.ndarray,
                gap_open: int, gap_extend: int, reverse: bool) -> torch.Tensor:
    """Plain version of the `ops/sw_cuda.py` kernels: the same (5, n)
    int64 job array in (qoff, qlen, toff, tlen, terminate), the same
    (6, n) int32 result, on the device of `qdata`.  Pairs are scanned in
    batches of similar length (gather_panels + make_profile + sw_scan_ref)."""
    def scan(j, Lq, Lt):
        qt, qb, tt = gather_panels(qdata, qbias, tdata, j[0], j[1], j[2],
                                   j[3], Lq, Lt, reverse)
        return sw_scan_ref(make_profile(qt, qb, sub), tt, j[1], j[3],
                           gap_open, gap_extend, j[4])
    return _jobs_ref(qdata.device, jobs, scan)


def sw_struct_jobs_ref(qss: torch.Tensor, qaa: torch.Tensor,
                       qbias: torch.Tensor, tss: torch.Tensor,
                       taa: torch.Tensor, m3di: torch.Tensor,
                       aasc: torch.Tensor, jobs: np.ndarray, gap_open: int,
                       gap_extend: int, reverse: bool) -> torch.Tensor:
    """Plain version of the structure-mode kernels (`sw_forward_struct` /
    `sw_reverse_struct`): jobs and result as sw_jobs_ref; the 3Di channel
    (qss/tss, m3di, the int8 3Di bias qbias) and the amino-acid channel
    (qaa/taa, aasc) are profiled and cast to int8 separately."""
    def scan(j, Lq, Lt):
        qs, qb, ts = gather_panels(qss, qbias, tss, j[0], j[1], j[2], j[3],
                                   Lq, Lt, reverse)
        qa, _qb, ta = gather_panels(qaa, qbias, taa, j[0], j[1], j[2], j[3],
                                    Lq, Lt, reverse)
        return sw_scan_ref(make_profile(qs, qb, m3di), ts, j[1], j[3],
                           gap_open, gap_extend, j[4],
                           prof2=make_profile(qa, None, aasc), tseq2=ta)
    return _jobs_ref(qss.device, jobs, scan)


def sw_prof_jobs_ref(qprof: torch.Tensor, tdata: torch.Tensor,
                     jobs: np.ndarray, gap_open: int, gap_extend: int,
                     reverse: bool) -> torch.Tensor:
    """Plain version of the profile-query kernels (`sw_forward_prof` /
    `sw_reverse_prof`): jobs and result as sw_jobs_ref; qprof holds the
    queries' int8 profile rows, PROF_COLS values a residue (flat), at the
    jobs' query element offsets.  Each job's (A, Lq) profile is cut out
    of it (flipped for reverse) and scanned without bias, cast through
    int8 as every profile is."""
    rows = qprof.reshape(-1, PROF_COLS)

    def scan(j, Lq, Lt):
        q_idx, t_idx = panel_index(j[0], j[1], j[2], j[3], Lq, Lt, reverse)
        prof = rows[q_idx].to(torch.int32).permute(0, 2, 1).contiguous()
        return sw_scan_ref(prof, tdata[t_idx].to(torch.int32), j[1], j[3],
                           gap_open, gap_extend, j[4])
    return _jobs_ref(qprof.device, jobs, scan)


def sw_shards_jobs_ref(qdata: torch.Tensor, qbias: torch.Tensor,
                       tparts: list, sub: torch.Tensor, jobs: np.ndarray,
                       gap_open: int, gap_extend: int,
                       reverse: bool) -> torch.Tensor:
    """Plain version of the target-sharded kernels (`sw_forward_shards` /
    `sw_reverse_shards`): a (6, n) int64 job array whose sixth row is the
    job's shard, an index into `tparts` (the shards' target tokens, toff
    shard-local); each shard's jobs go through sw_jobs_ref over that
    shard's tokens.  The (6, n) int32 result, job p in column p."""
    out = torch.empty((6, jobs.shape[1]), dtype=torch.int32,
                      device=qdata.device)
    for d in np.unique(jobs[5]):
        sel = np.nonzero(jobs[5] == d)[0]
        out[:, torch.from_numpy(sel).to(qdata.device)] = sw_jobs_ref(
            qdata, qbias, tparts[int(d)], sub,
            np.ascontiguousarray(jobs[:5, sel]), gap_open, gap_extend,
            reverse)
    return out
