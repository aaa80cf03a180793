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
                                        sw_jobs_ref, sw_scan_ref)
from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
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
    sw_cuda.reset_counts()
    for reverse, fn in ((False, sw_cuda.sw_forward),
                        (True, sw_cuda.sw_reverse)):
        got = fn(Q, QB, T, S, jobs, GO, GE)
        ref = sw_jobs_ref(Q, QB, T, S, jobs, GO, GE, reverse)
        assert torch.equal(got, ref)
    assert sw_cuda.FORWARD_LAUNCHES == sw_cuda.REVERSE_LAUNCHES == 0
    for bad in ((1, 0, 0), (0, -1, -1), (2, 0, len(t)), (3, 0, 0)):
        row, col, val = bad
        b = jobs.copy()
        b[row, col] = val
        with pytest.raises(ValueError):
            sw_cuda.sw_forward(Q, QB, T, S, b, GO, GE)
    with pytest.raises(ValueError):
        sw_cuda.sw_forward(Q, QB, T, S, jobs, 1, 2)     # go < ge


@pytest.mark.parametrize("cell", [8, 16])
def test_scratch_chunks_cover_and_bound(cell):
    """The launch split of a stage: contiguous, covering, and within the
    scratch budget except for a lone pair that alone exceeds it."""
    from spacedust_tpu_torch.ops.sw_cuda import scratch_chunks
    rng = np.random.default_rng(cell)
    tlen = np.sort(rng.integers(1, 3000, 5000))
    tlen[-1] = 50_000
    budget = 1 << 22
    chunks = scratch_chunks(tlen, cell, budget)
    assert chunks[0][0] == 0 and chunks[-1][1] == len(tlen)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    for s, e in chunks:
        assert e > s
        assert (e - s) * tlen[s:e].max() * cell <= budget or e - s == 1
    assert len(chunks) > 10
