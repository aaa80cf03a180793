"""The profile reverse stage's block path (csrc/sw.cu::sw_block_kernel<
true, kProfCell, W>, the entry point sw_reverse_prof_block) as the numpy
block model of test_torch_sw_block.py with the profile cell.

Each warp of the block stages its strip's profile rows into a shared
region of its own at the strip's start (test_torch_profile.py::
prof_slots) and reads its cells there; the rest is the sequence block
path's schedule (strips interleaved over W warps, the two-slot ring, the
chunk waits).  Held exactly against the plain version (ops/sw.py::
sw_prof_jobs_ref, itself equal to JAX sw_reverse_from_profiles by
test_torch_profile.py::test_prof_plain_matches_jax_b10) on ragged pairs
and on chip_smoke.py::block_edge_batch_prof, which the card's check runs
through the kernel at every width and class.  The planted fault "two
warps share one profile region" (the fault the per-warp regions exist to
avoid) fails under the downstream schedule.  Nothing on the CPU runs the
CUDA body: change the model and the kernel together."""

import numpy as np
import pytest
import torch

from spacedust_tpu_torch.ops.sw import PROF_COLS
from spacedust_tpu_torch.stats.submat import load_substitution_matrix
from test_torch_profile import _plain, _reverse_jobs
from test_torch_sw import GE, GO, LANES, ROWS, _chip_smoke
from test_torch_sw_block import WARPS, _ragged, block_model

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def _prof_block_jobs(rows, t, jobs, R, W, reverse, fault=None,
                     schedule="downstream", stats=None):
    """block_model with the profile cell over (5, n) jobs on resident
    (n, PROF_COLS) profile rows and target tokens."""
    out = []
    for p in range(jobs.shape[1]):
        qoff, qlen, toff, tlen = (int(x) for x in jobs[:4, p])
        prof = rows[qoff:qoff + qlen].astype(np.int64)
        tt = t[toff:toff + tlen].astype(np.int64)
        if reverse:
            prof, tt = prof[::-1], tt[::-1]
        st: dict = {}
        out.append(block_model(None, GO, GE, int(jobs[4, p]), R, W, reverse,
                               fault, schedule, tokens=tt, stats=st,
                               prof=prof))
        if stats is not None:
            for key, v in st.items():
                stats[key] = max(stats.get(key, 0), v)
    return np.array(out).T


def _prof_ragged(seed, n, R, W):
    """test_torch_sw_block.py::_ragged's pairs as profile rows: residue i
    becomes sub[q_i] + bias_i with noise in -3..3 on all 21 values (the
    pair of bias -40 scores 0)."""
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs = _ragged(seed, n, R, W)
    rng = np.random.default_rng(seed + 1)
    rows = (sub[q].astype(np.int32) + qb[:, None]
            + rng.integers(-3, 4, (len(q), PROF_COLS)))
    return rows.astype(np.int8), t, jobs


@pytest.mark.parametrize("schedule", ["downstream", "round_robin"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("W", WARPS)
def test_prof_block_model_matches_plain_ragged(W, R, reverse, schedule):
    """Ragged profile pairs (1 to 2W + 1 strips) on W warps at class R
    equal the plain version, forward and on the reverse jobs derived from
    it; under the downstream schedule some loads go ahead exactly at
    their wait, with warps inside strips at once."""
    rows, t, jobs = _prof_ragged(2000 * W + R, 6, R, W)
    fwd = _plain(rows, t, jobs, False)
    assert (fwd[0] == 0).any() and (fwd[0] > 0).sum() >= 3
    js = _reverse_jobs(jobs, fwd) if reverse else jobs
    want = _plain(rows, t, js, True) if reverse else fwd
    stats: dict = {}
    got = _prof_block_jobs(rows, t, js, R, W, reverse, schedule=schedule,
                           stats=stats)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])
    if reverse:
        assert want[3].all()
    if schedule == "downstream":
        assert stats["tight"] > 0 and stats["overlap"] >= 2


def _edges(R, W):
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    (flat, t), jobs, expect = smoke.block_edge_batch_prof(R, W, sub)
    return smoke, flat.reshape(-1, PROF_COLS), t, jobs, expect


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("W", WARPS)
def test_prof_block_model_matches_plain_edges(W, R, reverse):
    """chip_smoke.py::block_edge_batch_prof: the planted ties come out of
    the plain version where the design puts them, and the model agrees on
    every pair, forward, reverse on the whole pairs (terminate = their
    score) and on the derived prefixes."""
    smoke, rows, t, jobs, expect = _edges(R, W)
    fwd = _plain(rows, t, jobs, False)
    for p, want in expect.items():
        assert tuple(fwd[:3, p]) == want, (p, fwd[:3, p], want)
    if not reverse:
        np.testing.assert_array_equal(
            _prof_block_jobs(rows, t, jobs, R, W, False)[:3], fwd[:3])
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    for js in (whole, smoke.reverse_jobs(jobs, fwd)):
        want = _plain(rows, t, js, True)
        np.testing.assert_array_equal(
            _prof_block_jobs(rows, t, js, R, W, True), want)
        assert want[3].all()


@pytest.mark.parametrize("W", WARPS)
def test_prof_block_edges_expose_shared_region(W):
    """Two warps that share one profile region (warps 2m and 2m + 1)
    overwrite each other's rows at their strips' starts: the reverse
    model then differs from the plain version on the edge batch's pairs
    of W + 1 and 2W + 1 strips, under the downstream schedule."""
    smoke, rows, t, jobs, expect = _edges(4, W)
    strips = -(-jobs[1] // (LANES * 4))
    keep = np.nonzero((strips > W) & (jobs[3] > 32))[0]
    jobs = jobs[:, keep]
    fwd = _plain(rows, t, jobs, False)
    whole = jobs.copy()
    whole[4] = fwd[0]
    js = np.concatenate([whole, smoke.reverse_jobs(jobs, fwd)], axis=1)
    want = _plain(rows, t, js, True)
    np.testing.assert_array_equal(_prof_block_jobs(rows, t, js, 4, W, True),
                                  want)
    got = _prof_block_jobs(rows, t, js, 4, W, True, "shared_prof_region")
    assert (got != want).any()
