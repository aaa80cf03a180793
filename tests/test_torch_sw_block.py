"""The block path of the target-sharded SW stage (B8: csrc/sw.cu::
sw_block_pair / sw_block_kernel) as a numpy model, and the plan that
sends pairs to it (ops/sw_cuda.py::shard_plan).

On the card a long pair is swept by the W warps of a block: warp w takes
strips w, w + W, ..., each with the lone warp's strip sweep (the model's
`test_torch_sw.py::lane_strip`, the CUDA body's `sw_strips`); the boundary
lane 31 leaves after a column goes to a ring of two slots of tlen columns
(strip k writes slot k % 2 and reads slot (k - 1) % 2); before it loads a
chunk of 32 columns (the feed reads 32 to 63 columns ahead of the step)
a warp waits until the warp of the strip above has published that chunk
(a counter a warp, in 32-column chunks over all of its strips).  The
forward results of the warps merge lexicographically (score, then
smaller j, then smaller i); the reverse result is lane 31's trackers in
the warp of the last strip.  `block_model` drives W lane_strip
generators under a schedule: "downstream" always runs the warp of the
highest strip that may run (readers as early as the waits let them:
every race the waits allow happens), "round_robin" runs them in turn.
Held exactly against the plain scan (ops/sw.py, itself equal to the JAX
package's sw_scan_core in test_torch_sw.py) on ragged pairs and on
chip_smoke.py::block_edge_batch, which the card's check runs through the
kernels too.  With `prof` the model takes the profile cell of the
profile reverse stage's block path (sw_reverse_prof_block): each warp
stages its strip's profile rows into a region of its own at the strip's
start (test_torch_profile.py::prof_slots) and reads its cells there;
test_torch_sw_block_prof.py holds that form.  Nothing on the CPU runs
the CUDA body: change the model and the kernel together."""

import numpy as np
import pytest
import torch

from spacedust_tpu_torch.ops import sw_cuda
from spacedust_tpu_torch.ops.sw import PROF_COLS, sw_shards_jobs_ref
from spacedust_tpu_torch.stats.submat import load_substitution_matrix
from test_torch_profile import prof_slots
from test_torch_sw import (GE, GO, LANES, ROWS, _chip_smoke, _job_scores,
                           _plain_jobs, _scores, lane_strip, new_trackers,
                           warp_merge)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

WARPS = [2, 3, 4]
# the warps an H100 runs at once on the warp kernels (132 SMs x 16), which
# sw_cuda.card_warps reads from the card
H100_WARPS = 132 * sw_cuda.SM_WARPS
BLOCK_FAULTS = {
    "one_slot_ring": "strip k writes and strip k + 1 reads one slot",
    "wait_chunk_short": "a warp loads a chunk once the strip above has "
                        "published the chunk before it",
    "merge_earlier_warp_wins": "the warps' merge keeps the earlier warp on "
                               "an equal score",
    "tracker_wrong_warp": "the reverse result is read from the warp after "
                          "the one of the last strip",
    # the profile cell only
    "shared_prof_region": "two warps share one profile region",
}
# the faults that change what the block computes with the sequence cell;
# a one-slot ring does not (see test_one_slot_ring_is_no_fault)
CAUGHT = sorted(set(BLOCK_FAULTS) - {"one_slot_ring", "shared_prof_region"})


def _prof_regions(prof, R, W, fault):
    """The profile cell's shared memory: per warp, a function that stages
    strip k's rows into the warp's region (lane l's row r of the strip,
    clamped to the last row, at prof_slots; a token's 32 R rows
    contiguous) and a cell function that reads them.  Under the fault
    "shared_prof_region" warps 2m and 2m + 1 share one region."""
    qlen = len(prof)
    slots = prof_slots(R)
    region_of = [w // 2 if fault == "shared_prof_region" else w
                 for w in range(W)]
    regions = np.full((max(region_of) + 1, PROF_COLS * LANES * R), 99,
                      np.int64)                       # junk until staged
    rows = np.arange(LANES)[:, None] * R + np.arange(R)[None, :]

    def stage(w, k):
        i = np.minimum(k * LANES * R + rows, qlen - 1)
        for t in range(PROF_COLS):
            regions[region_of[w], t * LANES * R + slots] = prof[i, t]

    def cell_of(w):
        def cell(srow, tok):
            return regions[region_of[w]][tok[:, None] * LANES * R + slots]
        return cell

    return stage, [cell_of(w) for w in range(W)]


def block_model(S, go, ge, term, R, W, reverse, fault=None,
                schedule="downstream", tokens=None, stats=None, prof=None):
    """One pair on a block of W warps.  S and tokens as lane_model's;
    returns (score, t_end, q_end, found, fj, fi).  fault: one of
    BLOCK_FAULTS.  stats, if a dict, gets `tight`: the chunk loads that
    went ahead with the strip above exactly as far as the wait asks, and
    `overlap`: the most warps that were inside a strip at once.  prof:
    the profile cell in place of S, the pair's (qlen, PROF_COLS) profile
    rows (flipped for the reverse pass), tokens its target tokens: a warp
    stages each strip's rows into its own region before the strip's first
    wait, as sw_strips does, and reads its cells there."""
    assert fault is None or fault in BLOCK_FAULTS
    if prof is None:
        qlen, tlen, cell, tokens = _scores(S, tokens)
        cells = [cell] * W
    else:
        qlen, tlen = len(prof), len(tokens)
        stage, cells = _prof_regions(prof, R, W, fault)
    strip = LANES * R
    n_strips = -(-qlen // strip)
    n_chunks = -(-tlen // 32)
    slots = 1 if fault == "one_slot_ring" else 2
    ring = np.full((slots, tlen, 4), 777, np.int64)   # junk until written
    prog = [0] * W
    accs = [new_trackers() for _ in range(W)]

    def warp(w):
        for k in range(w, n_strips, W):
            if prof is not None:
                stage(w, k)
            for req in lane_strip(k * strip, qlen, tlen, cells[w], tokens,
                                  go, ge, term, R, reverse,
                                  ring[(k - 1) % slots], ring[k % slots],
                                  accs[w]):
                yield k, req

    def need(k, c0):
        short = fault == "wait_chunk_short"
        return ((k - 1) // W) * n_chunks + (c0 >> 5) + (0 if short else 1)

    def ready(k, req):
        kind, c0 = req
        if kind != "wait" or k == 0 or c0 >= tlen:
            return True
        return prog[(k - 1) % W] >= need(k, c0)

    gens = [warp(w) for w in range(W)]
    pend = [next(g, None) for g in gens]
    tight = overlap = turn = 0
    while any(p is not None for p in pend):
        runnable = [w for w in range(W)
                    if pend[w] is not None and ready(*pend[w])]
        assert runnable, "the waits deadlocked"
        if schedule == "downstream":
            w = max(runnable, key=lambda w: pend[w][0])
        else:
            w = min(runnable, key=lambda w: (w - turn) % W)
            turn = w + 1
        # a warp about to load its strip's first chunk is not inside one
        overlap = max(overlap, sum(p is not None and p[1] != ("wait", 0)
                                   for p in pend))
        k, (kind, c0) = pend[w]
        if (kind == "wait" and k > 0 and c0 < tlen
                and prog[(k - 1) % W] == need(k, c0)):
            tight += 1
        # run warp w up to its next step's end or its next wait
        while True:
            k, (kind, j) = pend[w]
            if kind == "wrote" and ((j & 31) == 31 or j == tlen - 1):
                prog[w] = (k // W) * n_chunks + (j >> 5) + 1
            pend[w] = next(gens[w], None)
            if pend[w] is None or pend[w][1][0] != "wrote":
                break
    if stats is not None:
        stats.update(tight=tight, overlap=overlap)
    if reverse:
        w = (n_strips - 1) % W if fault != "tracker_wrong_warp" else \
            n_strips % W
        return tuple(accs[w][k] for k in ("best", "bj", "bi", "found", "fj",
                                          "fi"))
    lb, lj, li = warp_merge(accs[0])
    for acc in accs[1:]:
        ob, oj, oi = warp_merge(acc)
        if fault == "merge_earlier_warp_wins":
            up = ob > lb
        else:
            up = ob > lb or (ob == lb and (oj < lj or (oj == lj and oi < li)))
        if up:
            lb, lj, li = ob, oj, oi
    return lb, lj, li, 0, -1, 0


def _block_jobs(q, qb, t, sub, jobs, R, W, reverse, fault=None,
                schedule="downstream", stats=None):
    out = []
    for p in range(jobs.shape[1]):
        st: dict = {}
        out.append(block_model(_job_scores(q, qb, t, sub, jobs[:, p],
                                           reverse), GO, GE, int(jobs[4, p]),
                               R, W, reverse, fault, schedule, stats=st))
        if stats is not None:
            for key, v in st.items():
                stats[key] = max(stats.get(key, 0), v)
    return np.array(out).T


def _reverse_of(jobs, fwd):
    keep = np.nonzero(fwd[0] > 0)[0]
    return np.ascontiguousarray(np.stack([
        jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep], fwd[1, keep] + 1,
        fwd[0, keep]]), dtype=np.int64)


def _ragged(seed, n, R, W):
    """Seeded pairs of 1 to 2W + 1 strips against targets of 1 to 120
    residues, every other one a homolog (a mutated copy of a query
    segment), a zero-score pair (bias -40) among them."""
    rng = np.random.default_rng(seed)
    qlens = rng.integers(1, (2 * W + 1) * LANES * R + 1, n)
    qlens[:3] = ((2 * W + 1) * LANES * R, W * LANES * R + 1, 1)
    tlens = rng.integers(1, 121, n)
    qs, ts = [], []
    for p in range(n):
        q = rng.integers(0, 20, qlens[p]).astype(np.uint8)
        t = rng.integers(0, 20, tlens[p]).astype(np.uint8)
        if p % 2 == 0:
            lo = int(rng.integers(0, max(qlens[p] - tlens[p], 0) + 1))
            seg = q[lo:lo + tlens[p]]
            t[:len(seg)] = seg
            hit = rng.integers(0, 100, tlens[p]) < 20
            t[hit] = rng.integers(0, 20, int(hit.sum()))
        qs.append(q)
        ts.append(t)
    qb = rng.integers(-3, 4, int(qlens.sum())).astype(np.int8)
    qoff = np.concatenate(([0], np.cumsum(qlens)[:-1]))
    qb[qoff[4]:qoff[4] + qlens[4]] = -40
    toff = np.concatenate(([0], np.cumsum(tlens)[:-1]))
    jobs = np.stack([qoff, qlens, toff, tlens,
                     np.full(n, -1)]).astype(np.int64)
    return np.concatenate(qs), qb, np.concatenate(ts), jobs


@pytest.mark.parametrize("schedule", ["downstream", "round_robin"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("W", WARPS)
def test_block_model_matches_scan_ref_ragged(W, R, reverse, schedule):
    """Ragged pairs (1 to 2W + 1 strips, every warp with no strip, one
    and several) on W warps at class R equal the plain scan, forward and
    on the reverse jobs derived from it; under the downstream schedule
    some loads go ahead exactly at their wait, with warps inside strips
    at once."""
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs = _ragged(1000 * W + R, 6, R, W)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    assert (fwd[0] == 0).any() and (fwd[0] > 0).sum() >= 3
    js = _reverse_of(jobs, fwd) if reverse else jobs
    want = _plain_jobs(q, qb, t, sub, js, True) if reverse else fwd
    stats: dict = {}
    got = _block_jobs(q, qb, t, sub, js, R, W, reverse, schedule=schedule,
                      stats=stats)
    n_out = 6 if reverse else 3
    np.testing.assert_array_equal(got[:n_out], want[:n_out])
    if reverse:
        assert want[3].all()
    if schedule == "downstream":
        assert stats["tight"] > 0 and stats["overlap"] >= 2


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("W", WARPS)
def test_block_model_matches_scan_ref_edges(W, R, reverse):
    """chip_smoke.py::block_edge_batch (the pairs the card's check runs
    through every width and class): forward with its planted ties where
    the design puts them (ties on strip boundaries that fall on different
    warps), reverse on the same pairs (terminate = their score) and on
    the derived prefixes."""
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs, expect = smoke.block_edge_batch(R, W, sub)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    for p, want in expect.items():
        assert tuple(fwd[:3, p]) == want, (p, fwd[:3, p], want)
    if not reverse:
        got = _block_jobs(q, qb, t, sub, jobs, R, W, False)
        np.testing.assert_array_equal(got[:3], fwd[:3])
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    for js in (whole, _reverse_of(jobs, fwd)):
        want = _plain_jobs(q, qb, t, sub, js, True)
        np.testing.assert_array_equal(
            _block_jobs(q, qb, t, sub, js, R, W, True), want)
        assert want[3].all()


def _fault_batch(W, R=4):
    """The edge batch's planted pairs and its pairs of W + 1 and 2W + 1
    strips (a last strip off warp W - 1, several strips a warp)."""
    smoke = _chip_smoke()
    sub = load_substitution_matrix().sub_int
    q, qb, t, jobs, expect = smoke.block_edge_batch(R, W, sub)
    strips = -(-jobs[1] // (LANES * R))
    keep = sorted(set(expect) | set(np.nonzero(
        (strips % W != 0) & (strips > W) & (jobs[3] > 32))[0].tolist()))
    return q, qb, t, jobs[:, keep], sub


@pytest.mark.parametrize("fault", CAUGHT)
@pytest.mark.parametrize("W", WARPS)
def test_block_edges_expose_planted_fault(W, fault):
    """Each planted fault of the block's schedule makes the model differ
    from the plain scan on the edge batch: forward for the merge and the
    waits, reverse (the same pairs at terminate = their score, and the
    derived prefixes) for the waits and the tracker's warp."""
    q, qb, t, jobs, sub = _fault_batch(W)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    if fault != "tracker_wrong_warp":
        got = _block_jobs(q, qb, t, sub, jobs, 4, W, False, fault)
        assert (got[:3] != fwd[:3]).any()
    if fault == "merge_earlier_warp_wins":
        return
    whole = jobs.copy()
    whole[4] = fwd[0]
    js = np.concatenate([whole, _reverse_of(jobs, fwd)], axis=1)
    want = _plain_jobs(q, qb, t, sub, js, True)
    got = _block_jobs(q, qb, t, sub, js, 4, W, True, fault)
    assert (got != want).any()


@pytest.mark.parametrize("W", WARPS)
def test_one_slot_ring_is_no_fault(W):
    """A ring of one slot, strip k + 1 reading where strip k writes and
    writing there itself, gives the plain scan's results under the
    downstream schedule too: a strip reads each column (32 to 63 steps
    ahead) before its lane 31 overwrites it (31 steps behind), and strip
    k + 1 reads a column only after strip k wrote it, so no write lands
    before the read it would spoil.  The kernel keeps two slots, which
    hold each strip's input and output apart."""
    q, qb, t, jobs, sub = _fault_batch(W)
    fwd = _plain_jobs(q, qb, t, sub, jobs, False)
    got = _block_jobs(q, qb, t, sub, jobs, 4, W, False, "one_slot_ring")
    np.testing.assert_array_equal(got[:3], fwd[:3])
    js = _reverse_of(jobs, fwd)
    np.testing.assert_array_equal(
        _block_jobs(q, qb, t, sub, js, 4, W, True, "one_slot_ring"),
        _plain_jobs(q, qb, t, sub, js, True))


# --------------------------------------------------------------- the plan
def _stage(seed=3, n=60_000):
    """A stage of the real set's size: 60,000 pairs of 1 to 1,500
    residues a side, three giants, a shard of three a pair."""
    rng = np.random.default_rng(seed)
    jobs = np.stack([rng.integers(0, 10**6, n), rng.integers(1, 1500, n),
                     rng.integers(0, 10**5, n), rng.integers(1, 1500, n),
                     np.full(n, -1), rng.integers(0, 3, n)]).astype(np.int64)
    # three giants, each of which alone would outlast an even share
    giants = [5, n // 2, n - 1]
    jobs[1, giants] = (5917, 5170, 40)
    jobs[3, giants] = (5496, 5917, 90_000)
    return jobs


@pytest.mark.parametrize("reverse", [False, True])
def test_shard_plan_long_pair_rule(reverse):
    """A pair takes the block path iff its one-warp lane-steps exceed the
    stage's total over the card's warps (an H100's 132 SMs x 16 here);
    the table holds the long pairs first,
    then the short ones, each group in the caller's order, every job
    once, with its shard; the short part is cut as _scratch_launches cuts
    the short pairs alone."""
    jobs = _stage()
    plan = sw_cuda.shard_plan(jobs, "shards", reverse, card_warps=H100_WARPS)
    one = sw_cuda.lane_rows(jobs[1])
    steps = -(-jobs[1] // (32 * one)) * (jobs[3] + 31)
    long = steps > steps.sum() / H100_WARPS
    assert 3 <= long.sum() < 50
    assert {5, 30_000, 59_999} <= set(np.nonzero(long)[0].tolist())
    nl = plan.n_long
    assert nl == long.sum()
    np.testing.assert_array_equal(plan.order[:nl], np.nonzero(long)[0])
    np.testing.assert_array_equal(plan.order[nl:], np.nonzero(~long)[0])
    np.testing.assert_array_equal(plan.table[:5], jobs[:5, plan.order])
    np.testing.assert_array_equal(plan.table[7], jobs[5, plan.order])
    # sorted longest first, the long pairs lead: the caller's order
    order = np.argsort(-(jobs[1] * jobs[3]), kind="stable")
    lead = sw_cuda.shard_plan(np.ascontiguousarray(jobs[:, order]),
                              "shards", reverse, card_warps=H100_WARPS)
    assert lead.perm is None and lead.n_long == nl
    short = np.empty((7, len(jobs[0]) - nl), dtype=np.int64)
    short[:5] = jobs[:5, ~long]
    short[5] = sw_cuda.lane_rows(short[1])
    launches = sw_cuda._scratch_launches(short, sw_cuda.WARP_SCRATCH[reverse],
                                         sw_cuda.SCRATCH_BYTES)
    np.testing.assert_array_equal(plan.table[:7, nl:], short)
    assert plan.launches == [(s + nl, e + nl, c) for s, e, c in launches]


@pytest.mark.parametrize("warps", [sw_cuda.BLOCK_WARPS])
def test_shard_plan_block_class_and_ring(warps):
    """The block path's class minimises ceil(strips / W) * (R +
    STEP_OVERHEAD_CELLS), ties to the larger class (at W = 16 the giant
    pair takes R = 12: 16 strips, 1 a warp, against 12 strips at R = 16
    and 24 at R = 8, 2 a warp); each long pair longer than one strip gets
    a ring of two slots of tlen columns, disjoint, from 0."""
    jobs = _stage()
    plan = sw_cuda.shard_plan(jobs, "shards", False, card_warps=H100_WARPS)
    nl = plan.n_long
    L = plan.table[:, :nl]
    for p in range(nl):
        costs = {R: -(-(-(-L[1, p] // (32 * R))) // warps)
                 * (R + sw_cuda.STEP_OVERHEAD_CELLS) for R in ROWS}
        best = min(costs.values())
        assert L[5, p] == max(R for R, c in costs.items() if c == best)
    giant = np.nonzero((L[1] == 5917) & (L[3] == 5496))[0][0]
    assert L[5, giant] == 12
    ring = np.where(L[1] > 32 * L[5], 2 * L[3], 0)
    np.testing.assert_array_equal(L[6], np.cumsum(ring) - ring)
    assert plan.long_cols == ring.sum()


def test_shard_plan_force_rows_and_refusals():
    """force sends every pair to the block path (or, False, none), rows
    fixes the class of every pair on both paths; forcing a stage without
    a block path (the structure stages, the profile forward stage) is
    refused."""
    jobs = _stage(n=200)
    plan = sw_cuda.shard_plan(jobs, "shards", True, force=True, rows=8,
                              card_warps=H100_WARPS)
    assert plan.n_long == 200 and plan.launches == []
    assert plan.perm is None
    assert (plan.table[5] == 8).all()
    plan = sw_cuda.shard_plan(jobs, "shards", True, rows=16,
                              card_warps=H100_WARPS)
    assert (plan.table[5] == 16).all() and plan.n_long >= 1
    plan = sw_cuda.shard_plan(jobs, "shards", True, force=False,
                              card_warps=H100_WARPS)
    assert plan.n_long == 0 and plan.perm is None
    assert plan.launches == [(0, 200, plan.launches[0][2])]
    for cell, reverse in (("struct", False), ("struct", True),
                          ("prof", False)):
        with pytest.raises(ValueError, match="no block path"):
            sw_cuda.shard_plan(jobs[:5], cell, reverse, force=True,
                               card_warps=H100_WARPS)


def test_sharded_wrapper_cpu_plain_version_and_checks():
    """On CPU tensors sw_forward_shards / sw_reverse_shards run each job
    against its shard's tokens (ops/sw.py::sw_shards_jobs_ref): equal to
    sw_forward / sw_reverse over each shard; a job outside its shard's
    tokens and a bad shard index are refused."""
    from test_torch_sw import _resident
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(8, 40, 300)
    sub = load_substitution_matrix().sub_int
    tt = [torch.from_numpy(x) for x in (t[:toffs[20]], t[toffs[20]:])]
    shard = (np.arange(40) >= 20).astype(np.int64)
    jobs = np.stack([qoffs[:-1], qlens, toffs[:-1] - shard * toffs[20],
                     tlens, np.full(40, -1), shard]).astype(np.int64)
    args = (torch.from_numpy(q), torch.from_numpy(qb))
    subt = torch.from_numpy(sub.astype(np.int8))
    targets = sw_cuda.ShardTargets(tt)
    assert targets.base is None
    fwd = sw_cuda.sw_forward_shards(*args, targets, subt, jobs, GO, GE)
    for d in (0, 1):
        sel = shard == d
        np.testing.assert_array_equal(
            fwd[:, torch.from_numpy(sel)].numpy(),
            sw_cuda.sw_forward(*args, tt[d], subt,
                               np.ascontiguousarray(jobs[:5, sel]), GO,
                               GE).numpy())
    f = fwd.numpy()
    rev = _reverse_of(jobs, f)
    keep = np.nonzero(f[0] > 0)[0]
    rjobs = np.concatenate([rev, shard[keep][None]])
    got = sw_cuda.sw_reverse_shards(*args, targets, subt, rjobs, GO, GE)
    np.testing.assert_array_equal(
        got.numpy(), sw_shards_jobs_ref(*args, tt, subt, rjobs, GO, GE,
                                        True).numpy())
    assert got[3].all()
    bad = jobs.copy()
    bad[2, 0] = len(tt[0])
    with pytest.raises(ValueError, match="inside"):
        sw_cuda.sw_forward_shards(*args, targets, subt, bad, GO, GE)
    bad = jobs.copy()
    bad[5, 3] = 2
    with pytest.raises(ValueError, match="inside"):
        sw_cuda.sw_forward_shards(*args, targets, subt, bad, GO, GE)
    with pytest.raises(ValueError, match=r"\(6, n\)"):
        sw_cuda.sw_forward_shards(*args, targets, subt, jobs[:5], GO, GE)


def test_flush_routes_each_job_to_its_shard_in_one_call_a_card():
    """ShardedAlignDB.flush hands the card's wrapper one table a stage:
    every job routed to the shard its global target offset lies in,
    toff made shard-local (inside the shard's tokens), all shards' jobs
    sorted longest first together; the results come back under each
    job's own position, equal to the single engine's."""
    from test_torch_sw import _resident
    from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
    from spacedust_tpu_torch.parallel.sw_sharded import (ShardedAlignDB,
                                                         make_mesh)
    q, qb, t, qoffs, qlens, toffs, tlens = _resident(12, 60, 200)
    sub = load_substitution_matrix().sub_int
    bounds = [(0, int(toffs[20])), (int(toffs[20]), int(toffs[45])),
              (int(toffs[45]), int(toffs[-1]))]
    sdb = ShardedAlignDB(make_mesh(3, "cpu"), q, qb, t, bounds, sub)
    n = 60
    rng = np.random.default_rng(2)
    pos = rng.permutation(n)
    job = (qoffs[:-1], qlens, toffs[:-1], tlens, np.full(n, -1), pos)
    seen = []
    saved = sw_cuda.sw_forward_shards

    def spy(qdata, qbias, targets, subt, jobs, *a, **kw):
        seen.append((targets, jobs.copy()))
        return saved(qdata, qbias, targets, subt, jobs, *a, **kw)

    sw_cuda.sw_forward_shards = spy
    try:
        got = np.zeros((6, n), np.int64)
        for p, c in sdb.run_buckets([job], GO, GE, False):
            got[:, p] = np.stack(c)
    finally:
        sw_cuda.sw_forward_shards = saved
    assert len(seen) == 1                      # one call: one card
    targets, js = seen[0]
    assert len(targets.tensors) == 3 and js.shape == (6, n)
    cells = js[1] * js[3]
    assert (np.diff(cells) <= 0).all()         # longest first, all shards
    starts = np.array([b[0] for b in bounds])
    glob = js[2] + starts[js[5]]
    np.testing.assert_array_equal(np.searchsorted(starts, glob, "right") - 1,
                                  js[5])
    lens = np.array([len(x) for x in targets.tensors])
    assert (js[2] >= 0).all() and (js[2] + js[3] <= lens[js[5]]).all()
    assert set(js[5].tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(np.sort(glob), np.sort(toffs[:-1]))
    single = DeviceAlignDB(q, qb, t, sub, "cpu")
    want = np.zeros((6, n), np.int64)
    for p, c in single.run_buckets([job], GO, GE, False):
        want[:, p] = np.stack(c)
    np.testing.assert_array_equal(got, want)
    assert sdb.metrics["shard_fwd_pairs"] == [20, 25, 15]
