"""The port's plain SW (ops/sw.py) and its engine (ops/sw_engine.py, on
the CPU) against the JAX package: sw_scan_core, the Pallas kernels in
interpret mode, and the JAX DeviceAlignDB.  Every comparison is exact:
all of it is integer math."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacedust_tpu.ops.sw_engine import DeviceAlignDB as JaxDeviceAlignDB
from spacedust_tpu.ops.sw_pallas import score_grid, sw_scan_pallas
from spacedust_tpu.ops.sw_tiled import sw_scan_core
from spacedust_tpu_torch.ops.sw import (gather_panels, make_profile,
                                        sw_jobs_ref, sw_scan_ref,
                                        sw_struct_jobs_ref)
from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
from spacedust_tpu_torch.search.structure import combined_matrices
from spacedust_tpu_torch.stats.submat import load_substitution_matrix

GO, GE = 11, 1
# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def _ragged_batch(seed: int, B: int = 16, Lq: int = 128, Lt: int = 256):
    """Random profiles with ragged lengths, an all-negative (zero-score)
    pair, a length-1 pair and planted ties (a repeated target motif)."""
    rng = np.random.default_rng(seed)
    prof = rng.integers(-8, 12, (B, 21, Lq)).astype(np.int32)
    tseq = rng.integers(0, 20, (B, Lt)).astype(np.int32)
    qlens = rng.integers(3, Lq + 1, B).astype(np.int32)
    tlens = rng.integers(3, Lt + 1, B).astype(np.int32)
    prof[0] = -5                                   # score 0
    qlens[1], tlens[1] = 1, 1                      # single cell
    tseq[2, :Lt // 2] = np.tile(tseq[2, :16], Lt // 32)   # tied maxima
    tlens[2] = Lt // 2
    return prof, tseq, qlens, tlens


_core_jit = jax.jit(functools.partial(sw_scan_core, gap_open=GO,
                                      gap_extend=GE, t_tile=32,
                                      all_outputs=True))


def _core(prof, tseq, qlens, tlens, term):
    return [np.asarray(x) for x in _core_jit(
        jnp.asarray(prof), jnp.asarray(tseq), jnp.asarray(qlens),
        jnp.asarray(tlens), terminate=jnp.asarray(term))]


def _ref(prof, tseq, qlens, tlens, term):
    return [x.numpy() for x in sw_scan_ref(
        torch.from_numpy(prof), torch.from_numpy(tseq),
        torch.from_numpy(qlens), torch.from_numpy(tlens), GO, GE,
        torch.from_numpy(term))]


@pytest.mark.parametrize("seed", [7, 8])
def test_scan_ref_matches_core(seed):
    prof, tseq, qlens, tlens = _ragged_batch(seed)
    B = len(qlens)
    off = np.full(B, -1, np.int32)
    ref = _core(prof, tseq, qlens, tlens, off)
    got = _ref(prof, tseq, qlens, tlens, off)
    for i in range(6):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"output {i}")
    assert ref[0][0] == 0 and ref[1][0] == -1
    # terminate = the best score (the reverse pass) and below it
    for term in (ref[0].astype(np.int32),
                 np.maximum(ref[0] - 3, 0).astype(np.int32)):
        ref_t = _core(prof, tseq, qlens, tlens, term)
        got_t = _ref(prof, tseq, qlens, tlens, term)
        for i in range(6):
            np.testing.assert_array_equal(got_t[i], ref_t[i],
                                          err_msg=f"terminate output {i}")


@pytest.mark.parametrize("per_column", [False, True])
def test_scan_ref_matches_pallas_interpret(per_column):
    """Pallas K1 (per_column=False) and K2 (per_column=True) in interpret
    mode on the CPU, as the JAX package's own tests run them."""
    prof, tseq, qlens, tlens = _ragged_batch(11)
    term = _ref(prof, tseq, qlens, tlens,
                np.full(len(qlens), -1, np.int32))[0].astype(np.int32)
    if not per_column:
        term = np.full(len(qlens), -1, np.int32)   # K1 has no tracker
    S = score_grid(jnp.asarray(prof), jnp.asarray(tseq))
    pal = [np.asarray(x) for x in sw_scan_pallas(
        S, jnp.asarray(qlens), jnp.asarray(tlens), jnp.asarray(term), GO, GE,
        all_outputs=True, bt=8, tt=32, interpret=True,
        per_column=per_column)]
    got = _ref(prof, tseq, qlens, tlens, term)
    for i in range(6):
        np.testing.assert_array_equal(got[i], pal[i], err_msg=f"output {i}")


def _resident(seed: int, n: int, max_len: int):
    """Concatenated query/target token + bias arrays with planted
    homologs; returns (q, qb, t, qoffs, qlens, toffs, tlens)."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(1, max_len + 1, n)
    tlens = rng.integers(1, max_len + 1, n)
    qlens[:2] = 1
    tlens[2:4] = 1
    qoffs = np.concatenate(([0], np.cumsum(qlens)))
    toffs = np.concatenate(([0], np.cumsum(tlens)))
    q = rng.integers(0, 21, qoffs[-1]).astype(np.uint8)
    t = rng.integers(0, 21, toffs[-1]).astype(np.uint8)
    for p in range(4, n, 2):
        m = min(qlens[p], tlens[p])
        t[toffs[p]:toffs[p] + m] = q[qoffs[p]:qoffs[p] + m]
    qb = rng.integers(-3, 4, len(q)).astype(np.int8)
    return q, qb, t, qoffs, qlens, toffs, tlens


def test_engine_matches_jax_device_db():
    """Forward then reverse through both engines on the same jobs; the
    JAX engine runs its XLA gather + sw_scan_core on the CPU."""
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(3, 40, 380)
    n = len(qlens)
    sub = load_substitution_matrix().sub_int
    jdb = JaxDeviceAlignDB(q, qb, t, sub, q_offsets=qoffs, t_offsets=toffs)
    tdb = DeviceAlignDB(q, qb, t, sub, device="cpu")
    pos = np.arange(n)

    def jax_jobs(ql, tl, term, sel):
        rung = 384
        return [((rung, rung), jdb.q_blk[sel], ql, jdb.t_blk[sel], tl,
                 term, pos[sel])]

    def collect(res, width):
        out = np.zeros((6, width), np.int64)
        for p, cols in res:
            for i in range(6):
                out[i, p] = cols[i]
        return out

    minus1 = np.full(n, -1, np.int64)
    jf = collect(jdb.run_buckets(jax_jobs(qlens, tlens, minus1, pos),
                                 GO, GE, reverse=False), n)
    tf = collect(tdb.run_buckets([(qoffs[:-1], qlens, toffs[:-1], tlens,
                                   minus1, pos)], GO, GE, reverse=False), n)
    np.testing.assert_array_equal(tf, jf)
    assert tdb.metrics["fwd_pairs"] == n

    keep = np.nonzero(jf[1] >= 0)[0]
    rq, rt = jf[2, keep] + 1, jf[1, keep] + 1
    jr = collect(jdb.run_buckets(
        [((384, 384), jdb.q_blk[keep], rq, jdb.t_blk[keep], rt,
          jf[0, keep], np.arange(len(keep)))], GO, GE, reverse=True),
        len(keep))
    tr = collect(tdb.run_buckets(
        [(qoffs[keep], rq, toffs[keep], rt, jf[0, keep],
          np.arange(len(keep)))], GO, GE, reverse=True), len(keep))
    np.testing.assert_array_equal(tr, jr)
    assert tr[3].all()                   # every terminate column found
    assert len(keep) > n // 3


@pytest.mark.parametrize("reverse", [False, True])
def test_long_pair_matches_core(reverse):
    """A pair longer than 4,096 on one side, through the port's gather +
    plain scan, against sw_scan_core on the same panels."""
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(5, 2, 300)
    rng = np.random.default_rng(9)
    q = np.concatenate([q, rng.integers(0, 21, 4500).astype(np.uint8)])
    qb = np.concatenate([qb, rng.integers(-3, 4, 4500).astype(np.int8)])
    t[toffs[1]:toffs[1] + 200] = q[-4000:-3800]          # a homolog
    qoff, ql = len(q) - 4500, 4500
    toff, tl = int(toffs[1]), int(tlens[1])
    sub = load_substitution_matrix().sub_int
    Q, QB, T = (torch.from_numpy(a) for a in (q, qb, t))
    S = torch.from_numpy(sub.astype(np.int8))
    fwd = sw_jobs_ref(Q, QB, T, S, np.array([[qoff], [ql], [toff], [tl],
                                              [-1]]), GO, GE, False)
    term = int(fwd[0, 0]) if reverse else -1
    qlen = int(fwd[2, 0]) + 1 if reverse else ql
    tlen = int(fwd[1, 0]) + 1 if reverse else tl
    assert fwd[0, 0] > 50
    Lt = ((tlen + 31) // 32) * 32
    qt, qbb, tt = gather_panels(Q, QB, T, torch.tensor([qoff]),
                                torch.tensor([qlen]), torch.tensor([toff]),
                                torch.tensor([tlen]), qlen, Lt, reverse)
    prof = make_profile(qt, qbb, S).numpy()
    ref = _core(prof, tt.numpy(), np.array([qlen], np.int32),
                np.array([tlen], np.int32), np.array([term], np.int32))
    got = sw_jobs_ref(Q, QB, T, S, np.array([[qoff], [qlen], [toff], [tlen],
                                              [term]]), GO, GE, reverse)
    np.testing.assert_array_equal(got.numpy()[:, 0],
                                  np.array([r[0] for r in ref]))
    if reverse:
        assert got[3, 0] == 1


def test_wrapper_cpu_takes_plain_version_and_checks_jobs():
    """On CPU tensors the kernel wrappers run the plain version and count
    no launch; malformed jobs raise before anything runs."""
    from spacedust_tpu_torch.ops import sw_cuda
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(4, 12, 60)
    sub = load_substitution_matrix().sub_int
    Q, QB, T = (torch.from_numpy(a) for a in (q, qb, t))
    S = torch.from_numpy(sub.astype(np.int8))
    jobs = np.stack([qoffs[:-1], qlens, toffs[:-1], tlens,
                     np.full(len(qlens), -1)]).astype(np.int64)
    before = sw_cuda.LAUNCHES.copy()
    for reverse, fn in ((False, sw_cuda.sw_forward),
                        (True, sw_cuda.sw_reverse)):
        got = fn(Q, QB, T, S, jobs, GO, GE)
        ref = sw_jobs_ref(Q, QB, T, S, jobs, GO, GE, reverse)
        assert torch.equal(got, ref)
    assert sw_cuda.LAUNCHES == before
    for bad in ((1, 0, 0), (0, -1, -1), (2, 0, len(t)), (3, 0, 0)):
        row, col, val = bad
        b = jobs.copy()
        b[row, col] = val
        with pytest.raises(ValueError):
            sw_cuda.sw_forward(Q, QB, T, S, b, GO, GE)
    with pytest.raises(ValueError):
        sw_cuda.sw_forward(Q, QB, T, S, jobs, 1, 2)     # go < ge


# ---------------------------------------------------------------------
# The lane schedule of the CUDA body (csrc/sw.cu::sw_warp_pair, all four
# kernels), modelled in numpy: 32 lanes x R rows, the step loop
# j = s - lane, shuffles as array shifts, the chunk feed of lane 0, the
# in-place strip boundary, the per-lane forward trackers and their merge,
# the reverse column-max hand-down.  The kernel is written from it; here
# it is held against sw_scan_ref.  Nothing here runs the CUDA body: model
# and kernel meet only on the card (chip_smoke.py --phases kernels,
# kernels-struct, on the same edge_batch / edge_batch_struct).  FAULTS are
# mistakes planted in the model, one at a time, each of which the edge
# batches must expose.  The structure kernels differ in the cell score
# and in what travels as the target token: both channels' tokens packed
# into one value, which the model hands down and takes apart as they do
# (`tokens`, `_struct_cell`).
LANES = 32
NEG = -(1 << 30)


def _shfl_up(x, fill):
    """lane l receives lane l - 1's value; lane 0 receives `fill` (the
    CUDA lane 0 keeps its own value and overwrites it from the chunk)."""
    return np.concatenate(([fill], x[:-1]))


FAULTS = {
    # forward
    "lane_f_lost": "F does not cross from a lane to the next",
    "strip_f_lost": "F does not cross the strip boundary",
    "lane_merge_any_row": "the warp merge ignores the row on equal (score, j)",
    "strip_merge_score_only": "a later strip wins only on a greater score",
    # reverse
    "later_row_takes_tie": "a row replaces an equal column max",
    "strip_cmax_lost": "the column max does not cross the strip boundary",
}


def _scores(S, tokens):
    """(qlen, tlen, cell, tokens) of lane_model's S and tokens."""
    if tokens is None:
        qlen, tlen = S.shape

        def cell(srow, tok):
            return S[srow, tok[:, None]]

        return qlen, tlen, cell, np.arange(tlen)
    (qlen, cell), tlen = S, len(tokens)
    return qlen, tlen, cell, tokens


def new_trackers():
    """What a warp carries over its strips: per lane the forward best
    (lb, lj, li); lane 31's reverse trackers of the last strip."""
    return {"lb": np.zeros(LANES, np.int64), "lj": np.full(LANES, -1),
            "li": np.zeros(LANES, np.int64), "best": 0, "bj": -1, "bi": 0,
            "found": 0, "fj": -1, "fi": 0}


def lane_strip(i0, qlen, tlen, cell, tokens, go, ge, term, R, reverse,
               bin_, bout, acc, fault=None):
    """One strip (rows i0 .. i0 + 32 R - 1) on one warp, as the CUDA body's
    sw_strips sweeps it, a generator: it yields ("wait", c0) before it
    loads the chunk of columns c0 .. c0 + 31 (target tokens and, past the
    first strip, the boundary in bin_), ("wrote", j) after lane 31 left
    column j's boundary in bout (every strip but the last) and ("step",
    s) after wavefront step s, so that a scheduler can interleave warps.
    acc: the warp's trackers (new_trackers), updated in place."""
    lane = np.arange(LANES)
    strip = LANES * R
    first, last = i0 == 0, qlen - i0 <= strip
    rows = i0 + lane[:, None] * R + np.arange(R)[None, :]
    valid = rows < qlen
    srow = np.minimum(rows, qlen - 1)
    H = np.zeros((LANES, R), np.int64)
    E = np.full((LANES, R), NEG, np.int64)
    sb, sj, si = (np.zeros(LANES, np.int64), np.full(LANES, -1),
                  np.zeros(LANES, np.int64))
    diag_up = np.zeros(LANES, np.int64)
    col_o = np.zeros(LANES, np.int64)        # the target token's stand-in
    h_o, f_o = np.zeros(LANES, np.int64), np.full(LANES, NEG)
    c_o, ci_o = np.full(LANES, -1), np.zeros(LANES, np.int64)

    def load_chunk(c0):
        cols = c0 + lane
        ok = cols < tlen
        # a token past tlen is junk
        tok = np.where(ok, tokens[np.minimum(cols, tlen - 1)], -7)
        b = np.tile(np.array([0, NEG, -1, 0]), (LANES, 1))
        if not first:
            b[ok] = bin_[cols[ok]]
            if fault == "strip_f_lost":
                b[:, 1] = NEG
            if fault == "strip_cmax_lost":
                b[:, 2:] = (-1, 0)
        return tok, b

    yield ("wait", 0)
    nxt = load_chunk(0)
    for s in range(tlen + LANES - 1):
        k = s % LANES
        if k == 0:
            ctok, cb = nxt
            yield ("wait", s + LANES)
            nxt = load_chunk(s + LANES)
        col = _shfl_up(col_o, ctok[k])
        hin, fin = _shfl_up(h_o, cb[k, 0]), _shfl_up(f_o, cb[k, 1])
        if fault == "lane_f_lost":
            fin[1:] = NEG
        cin, ciin = _shfl_up(c_o, cb[k, 2]), _shfl_up(ci_o, cb[k, 3])
        j = s - lane
        act = (j >= 0) & (j < tlen)
        # the token travelled right
        assert (col[act] == tokens[j[act]]).all()
        sc = cell(srow, np.where(act, col, tokens[0]))
        F, diag = fin.copy(), diag_up.copy()
        cmax, ci = cin.copy(), ciin.copy()
        newH, newE = H.copy(), E.copy()
        m = np.zeros(LANES, np.int64)
        for r in range(R):
            e = np.maximum(E[:, r] - ge, H[:, r] - go)
            hb = np.maximum(np.maximum(diag + sc[:, r], e), 0)
            h = np.where(valid[:, r], np.maximum(hb, F), 0)
            F = np.maximum(F - ge, hb - go)
            diag = H[:, r]
            newH[:, r], newE[:, r] = h, e
            if reverse:
                up = (h >= cmax if fault == "later_row_takes_tie"
                      else h > cmax)
                cmax, ci = (np.where(up, h, cmax),
                            np.where(up, rows[:, r], ci))
            else:
                m = np.maximum(m, h)
        # commit the active lanes only
        a2 = act[:, None]
        H, E = np.where(a2, newH, H), np.where(a2, newE, E)
        diag_up = np.where(act, hin, diag_up)
        up = act & (m > sb)
        first_row = rows[lane, np.argmax(H == m[:, None], axis=1)]
        sb, sj, si = (np.where(up, m, sb), np.where(up, j, sj),
                      np.where(up, first_row, si))
        col_o, h_o, f_o = (np.where(act, col, col_o),
                           np.where(act, H[:, -1], h_o),
                           np.where(act, F, f_o))
        c_o, ci_o = np.where(act, cmax, c_o), np.where(act, ci, ci_o)
        if act[31]:
            j31 = int(j[31])
            if not last:
                bout[j31] = (h_o[31], f_o[31], c_o[31], ci_o[31])
                yield ("wrote", j31)
            elif reverse:
                if c_o[31] > acc["best"]:
                    acc["best"], acc["bj"], acc["bi"] = (int(c_o[31]), j31,
                                                         int(ci_o[31]))
                if not acc["found"] and c_o[31] == term:
                    acc["found"], acc["fj"], acc["fi"] = 1, j31, int(ci_o[31])
        yield ("step", s)
    lb, lj, li = acc["lb"], acc["lj"], acc["li"]
    up = sb > lb
    if fault != "strip_merge_score_only":
        up |= (sb == lb) & (sj < lj)
    acc["lb"], acc["lj"], acc["li"] = (np.where(up, sb, lb),
                                       np.where(up, sj, lj),
                                       np.where(up, si, li))


def warp_merge(acc, fault=None):
    """The forward lanes' (score, j, i) merged by the xor butterfly;
    returns the warp's (score, j, i)."""
    lane = np.arange(LANES)
    lb, lj, li = acc["lb"], acc["lj"], acc["li"]
    d = LANES // 2
    while d:
        ob, oj, oi = lb[lane ^ d], lj[lane ^ d], li[lane ^ d]
        rowwise = (oi < li) & (fault != "lane_merge_any_row")
        up = (ob > lb) | ((ob == lb) & ((oj < lj) | ((oj == lj) & rowwise)))
        lb, lj, li = (np.where(up, ob, lb), np.where(up, oj, lj),
                      np.where(up, oi, li))
        d //= 2
    assert (lb == lb[0]).all() and (lj == lj[0]).all()
    return int(lb[0]), int(lj[0]), int(li[0])


def lane_model(S, go, ge, term, R, reverse, fault=None, tokens=None):
    """One pair.  S: (qlen, tlen) cell scores, already flipped for the
    reverse pass.  Returns (score, t_end, q_end, found, fj, fi).  fault:
    one of FAULTS, planted.  tokens: the value that travels down the
    lanes for each target column (default: the column's index); when
    given, S is (qlen, a function of (rows, tokens) -> cell scores).
    One warp sweeps the strips in order, the boundary in place."""
    assert fault is None or fault in FAULTS
    qlen, tlen, cell, tokens = _scores(S, tokens)
    acc = new_trackers()
    bnd = np.zeros((tlen, 4), np.int64)          # lane 31's hand-over
    for i0 in range(0, qlen, LANES * R):
        for _ in lane_strip(i0, qlen, tlen, cell, tokens, go, ge, term, R,
                            reverse, bnd, bnd, acc, fault):
            pass
    if not reverse:
        return (*warp_merge(acc, fault), 0, -1, 0)
    return tuple(acc[k] for k in ("best", "bj", "bi", "found", "fj", "fi"))


def _job_scores(q, qb, t, sub, job, reverse):
    """(qlen, tlen) cell scores int8(sub[q_i][t_j] + bias_i) of one job,
    flipped for the reverse pass."""
    qoff, qlen, toff, tlen = (int(x) for x in job[:4])
    qq, bb, tt = (q[qoff:qoff + qlen], qb[qoff:qoff + qlen],
                  t[toff:toff + tlen])
    if reverse:
        qq, bb, tt = qq[::-1], bb[::-1], tt[::-1]
    S = sub[qq.astype(np.int64)][:, tt.astype(np.int64)] + bb[:, None]
    return S.astype(np.int8).astype(np.int64)


def _model_jobs(q, qb, t, sub, jobs, R, reverse, fault=None):
    return np.array([lane_model(_job_scores(q, qb, t, sub, jobs[:, p],
                                            reverse), GO, GE,
                                int(jobs[4, p]), R, reverse, fault)
                     for p in range(jobs.shape[1])]).T


def _plain_jobs(q, qb, t, sub, jobs, reverse):
    return sw_jobs_ref(torch.from_numpy(q), torch.from_numpy(qb),
                       torch.from_numpy(t),
                       torch.from_numpy(sub.astype(np.int8)), jobs, GO, GE,
                       reverse).numpy()


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS = [4, 8, 12, 16]


def test_lane_rows_are_the_compiled_classes():
    from spacedust_tpu_torch.ops.sw_cuda import (LANE_ROWS,
                                                 STEP_OVERHEAD_CELLS,
                                                 lane_rows)
    assert list(LANE_ROWS) == ROWS
    qlen = np.arange(1, 20_000)
    got = lane_rows(qlen)
    assert set(got.tolist()) == set(ROWS)
    # one strip whenever a class holds the query, and then the smallest
    for R in ROWS:
        fits = (qlen <= 32 * R) & (qlen > 32 * (R - 4))
        assert (got[fits] == R).all()
    # never more lane-steps than the widest class takes
    def steps(R):
        return -(-qlen // (32 * R)) * (R + STEP_OVERHEAD_CELLS)
    assert (steps(got) <= steps(16)).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_lane_model_matches_scan_ref_ragged(R, reverse):
    """Seeded ragged pairs (homologs, a zero-score pair, length 1, more
    than one strip) through the lane model at class R and the plain scan."""
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(20 + R, 14, 70 * R)
    qb[qoffs[5]:qoffs[6]] = -40                   # a zero-score pair
    sub = load_substitution_matrix().sub_int
    jobs = np.stack([qoffs[:-1], qlens, toffs[:-1], tlens,
                     np.full(len(qlens), -1)]).astype(np.int64)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    if reverse:
        keep = np.nonzero(fwd[0] > 0)[0]
        jobs = np.stack([jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep],
                         fwd[1, keep] + 1, fwd[0, keep]]).astype(np.int64)
        want = _plain_jobs(q, qb, t, sub, jobs, True)
        assert want[3].all() and len(keep) >= 6
    else:
        want = fwd
        assert (fwd[0] == 0).any() and (qlens > 32 * R).any()
    got = _model_jobs(q, qb, t, sub, jobs, R, reverse)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])
    if not reverse:
        assert (got[3] == 0).all() and (got[4] == -1).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_lane_model_matches_scan_ref_edges(R, reverse):
    """The smoke run's boundary shapes and planted ties (chip_smoke.py::
    edge_batch): qlen around R and the strip, tlen below and around the
    warp width, ties across lane and strip boundaries in both directions.
    Reverse: the same pairs with terminate = their score, and the derived
    prefix jobs, whose terminate column's max sits in the first strip."""
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs, expect = smoke.edge_batch(R, sub)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    for p, want in expect.items():
        assert tuple(fwd[:3, p]) == want, (p, fwd[:3, p], want)
    if not reverse:
        got = _model_jobs(q, qb, t, sub, jobs, R, False)
        np.testing.assert_array_equal(got[:3], fwd[:3])
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    derived = smoke.reverse_jobs(jobs, fwd)
    multi = derived[1] > 32 * R
    assert multi.sum() >= 4                       # the hand-down is used
    for js in (whole, derived):
        want = _plain_jobs(q, qb, t, sub, js, True)
        got = _model_jobs(q, qb, t, sub, js, R, True)
        np.testing.assert_array_equal(got, want)
    assert want[3].all()
    # the terminate column's max sits in the first strip of several
    assert (want[5][multi] < 32 * R).any()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("R", ROWS)
def test_edge_batch_exposes_planted_fault(R, fault):
    """edge_batch's planted ties and gaps (and, in reverse, the jobs
    derived from them) tell the lane model with one fault planted from the
    plain scan, at every class: the coverage the kernel's check on the
    card relies on."""
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs, expect = smoke.edge_batch(R, sub)
    planted = jobs[:, sorted(expect)]
    fwd = _plain_jobs(q, qb, t, sub, planted, False)
    reverse = fault in ("later_row_takes_tie", "strip_cmax_lost")
    if not reverse:
        got = _model_jobs(q, qb, t, sub, planted, R, False, fault)
        assert (got[:3] != fwd[:3]).any()
        return
    whole = planted.copy()
    whole[4] = fwd[0]
    js = np.concatenate([whole, smoke.reverse_jobs(planted, fwd)], axis=1)
    want = _plain_jobs(q, qb, t, sub, js, True)
    got = _model_jobs(q, qb, t, sub, js, R, True, fault)
    assert (got != want).any()


# --- the structure kernels on the same schedule ------------------------
STRUCT_GO = 10


def _struct_tables():
    m3di, aasc, _ = combined_matrices()
    return m3di.astype(np.int8), aasc.astype(np.int8)


def _struct_cell(arrays, tables, job, reverse):
    """(qlen, cell function) and the packed target tokens of one job, as
    the structure kernels form them: a column's tokens travel as
    t_ss | t_aa << 8, and a cell scores int8(m3di[q_ss][t_ss] + bias) +
    int8(aasc[q_aa][t_aa]) from the two halves."""
    qss, qaa, qb, tss, taa = arrays
    m3di, aasc = tables
    qoff, qlen, toff, tlen = (int(x) for x in job[:4])
    qs, qa, bb = (a[qoff:qoff + qlen].astype(np.int64)
                  for a in (qss, qaa, qb))
    ts, ta = (a[toff:toff + tlen].astype(np.int64) for a in (tss, taa))
    if reverse:
        qs, qa, bb, ts, ta = (a[::-1] for a in (qs, qa, bb, ts, ta))

    def cell(srow, tok):
        t_ss, t_aa = (tok & 0xff)[:, None], (tok >> 8)[:, None]
        ch1 = (m3di[qs[srow], t_ss] + bb[srow]).astype(np.int8)
        return ch1.astype(np.int64) + aasc[qa[srow], t_aa]

    return (qlen, cell), ts | ta << 8


def _struct_model_jobs(arrays, tables, jobs, R, reverse, fault=None):
    out = []
    for p in range(jobs.shape[1]):
        S, tokens = _struct_cell(arrays, tables, jobs[:, p], reverse)
        out.append(lane_model(S, STRUCT_GO, GE, int(jobs[4, p]), R, reverse,
                              fault, tokens))
    return np.array(out).T


def _struct_plain_jobs(arrays, tables, jobs, reverse):
    qss, qaa, qb, tss, taa = (torch.from_numpy(a) for a in arrays)
    m3di, aasc = (torch.from_numpy(m) for m in tables)
    return sw_struct_jobs_ref(qss, qaa, qb, tss, taa, m3di, aasc, jobs,
                              STRUCT_GO, GE, reverse).numpy()


def _struct_resident(seed: int, n: int, max_len: int):
    """Two-channel resident arrays: the 3Di channel of _resident, amino
    acids of their own that follow the planted 3Di homologs in part, a
    zero-score pair and a pair whose 3Di bias wraps int8."""
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(seed, n, max_len)
    rng = np.random.default_rng(seed + 1)
    qaa = rng.integers(0, 21, len(q)).astype(np.uint8)
    taa = rng.integers(0, 21, len(t)).astype(np.uint8)
    for p in range(4, n, 2):
        m = min(qlens[p], tlens[p])
        keep = rng.integers(0, 100, m) < 40
        taa[toffs[p]:toffs[p] + m][keep] = qaa[qoffs[p]:qoffs[p] + m][keep]
    qb[qoffs[5]:qoffs[6]] = -100                  # a zero-score pair
    qb[qoffs[6]:qoffs[7]] = rng.integers(-128, 128, qlens[6])   # wraps
    jobs = np.stack([qoffs[:-1], qlens, toffs[:-1], tlens,
                     np.full(n, -1)]).astype(np.int64)
    return [q, qaa, qb, t, taa], jobs


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_struct_lane_model_matches_plain_ragged(R, reverse):
    """Seeded ragged two-channel pairs through the lane model with the
    structure kernels' cell and packed tokens, at every class they can
    pick, against sw_struct_jobs_ref."""
    arrays, jobs = _struct_resident(40 + R, 14, 70 * R)
    tables = _struct_tables()
    fwd = _struct_plain_jobs(arrays, tables, jobs, False)
    if reverse:
        keep = np.nonzero(fwd[0] > 0)[0]
        jobs = np.stack([jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep],
                         fwd[1, keep] + 1, fwd[0, keep]]).astype(np.int64)
        want = _struct_plain_jobs(arrays, tables, jobs, True)
        assert want[3].all() and len(keep) >= 6
    else:
        want = fwd
        assert (fwd[0] == 0).any() and (jobs[1] > 32 * R).any()
    got = _struct_model_jobs(arrays, tables, jobs, R, reverse)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
def test_struct_lane_model_matches_plain_edges(R, reverse):
    """The smoke run's two-channel boundary shapes and ties
    (chip_smoke.py::edge_batch_struct), as
    test_lane_model_matches_scan_ref_edges: the ties planted on the
    summed score come out of the plain version where the design puts
    them, and the model agrees on every pair."""
    smoke = _chip_smoke()
    tables = _struct_tables()
    arrays, jobs, expect = smoke.edge_batch_struct(R, *tables)
    assert (arrays[0] != arrays[1]).any() and arrays[1].max() == 20
    fwd = _struct_plain_jobs(arrays, tables, jobs, False)
    for p, want in expect.items():
        assert tuple(fwd[:3, p]) == want, (p, fwd[:3, p], want)
    if not reverse:
        got = _struct_model_jobs(arrays, tables, jobs, R, False)
        np.testing.assert_array_equal(got[:3], fwd[:3])
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    derived = smoke.reverse_jobs(jobs, fwd)
    multi = derived[1] > 32 * R
    assert multi.sum() >= 4
    for js in (whole, derived):
        want = _struct_plain_jobs(arrays, tables, js, True)
        got = _struct_model_jobs(arrays, tables, js, R, True)
        np.testing.assert_array_equal(got, want)
    assert want[3].all()
    assert (want[5][multi] < 32 * R).any()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("R", ROWS)
def test_struct_edge_batch_exposes_planted_fault(R, fault):
    """edge_batch_struct tells the two-channel lane model with one fault
    planted from the plain version, at every class."""
    smoke = _chip_smoke()
    tables = _struct_tables()
    arrays, jobs, expect = smoke.edge_batch_struct(R, *tables)
    planted = jobs[:, sorted(expect)]
    fwd = _struct_plain_jobs(arrays, tables, planted, False)
    if fault not in ("later_row_takes_tie", "strip_cmax_lost"):
        got = _struct_model_jobs(arrays, tables, planted, R, False, fault)
        assert (got[:3] != fwd[:3]).any()
        return
    whole = planted.copy()
    whole[4] = fwd[0]
    js = np.concatenate([whole, smoke.reverse_jobs(planted, fwd)], axis=1)
    want = _struct_plain_jobs(arrays, tables, js, True)
    got = _struct_model_jobs(arrays, tables, js, R, True, fault)
    assert (got != want).any()


@pytest.mark.parametrize("reverse", [False, True])
def test_struct_packed_tokens_at_alphabet_ends(reverse):
    """Tokens 0 and 20 only, in both channels and on both sides: the
    packed hand-down keeps the halves apart (20 << 8 | 0, 0 << 8 | 20,
    ...), over more than one strip."""
    rng = np.random.default_rng(77)
    n, R = 6, 4
    qlens = rng.integers(100, 300, n)
    tlens = rng.integers(40, 120, n)
    qoffs = np.concatenate(([0], np.cumsum(qlens)))
    toffs = np.concatenate(([0], np.cumsum(tlens)))
    qss, qaa = (rng.choice([0, 20], qoffs[-1]).astype(np.uint8)
                for _ in range(2))
    tss, taa = (rng.choice([0, 20], toffs[-1]).astype(np.uint8)
                for _ in range(2))
    arrays = [qss, qaa, rng.integers(-3, 4, qoffs[-1]).astype(np.int8),
              tss, taa]
    tables = _struct_tables()
    jobs = np.stack([qoffs[:-1], qlens, toffs[:-1], tlens,
                     np.full(n, -1)]).astype(np.int64)
    packed = {int(v) for p in range(n) for v in _struct_cell(
        arrays, tables, jobs[:, p], False)[1]}
    assert packed == {0, 20, 20 << 8, 20 << 8 | 20}
    fwd = _struct_plain_jobs(arrays, tables, jobs, False)
    assert (fwd[0] > 0).all() and (qlens > 32 * R).any()
    if reverse:
        jobs[4] = fwd[0]
    want = _struct_plain_jobs(arrays, tables, jobs, reverse)
    got = _struct_model_jobs(arrays, tables, jobs, R, reverse)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])


@pytest.mark.parametrize("cell", [8, 16])
def test_warp_plan_covers_and_bounds(cell):
    """The warp kernels' launches, as shard_plan cuts a structure stage
    (no block path) of `cell` scratch bytes a column (8 forward, 16
    reverse): the caller's order, a class per pair, scratch only for
    multi-strip pairs, disjoint within a launch and within the budget
    except for a lone pair that alone exceeds it."""
    from spacedust_tpu_torch.ops.sw_cuda import (WARP_SCRATCH, lane_rows,
                                                 shard_plan)
    reverse = cell == WARP_SCRATCH[True]
    assert WARP_SCRATCH[reverse] == cell

    def warp_plan(jobs, budget=None, rows=None):
        kw = {} if budget is None else {"budget": budget}
        plan = shard_plan(jobs, "struct", reverse, rows=rows,
                          card_warps=132 * 16, **kw)
        assert plan.perm is None and plan.n_long == plan.long_cols == 0
        assert (plan.table[7] == 0).all()
        return plan.table, plan.launches
    rng = np.random.default_rng(cell)
    n = 4000
    jobs = np.stack([rng.integers(0, 10**6, n), rng.integers(1, 3000, n),
                     rng.integers(0, 10**6, n), rng.integers(1, 3000, n),
                     np.full(n, -1)]).astype(np.int64)
    jobs[3, 17] = 90_000
    jobs[1, 17] = 5000
    budget = 1 << 19
    table, launches = warp_plan(jobs, budget)
    np.testing.assert_array_equal(table[:5], jobs)
    np.testing.assert_array_equal(table[5], lane_rows(jobs[1]))
    assert launches[0][0] == 0 and launches[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(launches, launches[1:]))
    multi = table[1] > 32 * table[5]
    need = np.where(multi, table[3], 0)
    for s, e, cols in launches:
        assert e > s
        np.testing.assert_array_equal(
            table[6, s:e][multi[s:e]],
            (np.cumsum(need[s:e]) - need[s:e])[multi[s:e]])
        assert cols == need[s:e].sum()
        assert cols * cell <= budget or e - s == 1
    assert len(launches) > 8 and (17, 18, 90_000) in launches
    # one launch within the default bound, and one class when asked
    table, launches = warp_plan(jobs, rows=8)
    assert launches == [(0, n, int(np.where(jobs[1] > 256, jobs[3],
                                            0).sum()))]
    assert (table[5] == 8).all()


def test_dispatch_order_per_engine():
    """Both engines hand a stage to their kernels longest pair first."""
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.ops.sw_engine import StructureDeviceDB
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(6, 30, 90)
    sub = load_substitution_matrix().sub_int
    job = (qoffs[:-1], qlens, toffs[:-1], tlens,
           np.full(len(qlens), -1), np.arange(len(qlens)))
    seen = {}

    def spy(name, fn):
        def call(*args, **kw):
            seen[name] = args[-3]
            return fn(*args, **kw)
        return call

    saved = {n: getattr(sw_cuda, n) for n in ("sw_forward",
                                              "sw_forward_struct")}
    try:
        for n, fn in saved.items():
            setattr(sw_cuda, n, spy(n, fn))
        DeviceAlignDB(q, qb, t, sub, device="cpu").run_buckets(
            [job], GO, GE, reverse=False)
        StructureDeviceDB(q, q, qb, t, t, sub, sub, device="cpu"
                          ).run_buckets([job], GO, GE, reverse=False)
    finally:
        for n, fn in saved.items():
            setattr(sw_cuda, n, fn)
    for name in saved:
        cells = seen[name][1] * seen[name][3]
        assert (np.diff(cells) <= 0).all() and cells[0] > cells[-1]
