"""The target-sharded search of the port (ROADMAP A8 / B8) against the JAX
package on the same inputs, SW on the CPU (plain version): the concurrent
split prefilter, the sharded SW grid (`ShardedAlignDB.run_grid` and
`gather_scores`) on JAX's 8-device CPU mesh, the sharded search records,
the alignment controls on the sharded engine, and the sharded
clustersearch against the recorded fixture.  Equal, not close; inputs
made from seeds."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.parallel import pipeline as jax_pipeline
from spacedust_tpu.parallel import sw_sharded as jax_sharded
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.native import comp_bias_batch
from spacedust_tpu_torch.parallel import pipeline
from spacedust_tpu_torch.parallel.split import residue_balanced_splits
from spacedust_tpu_torch.parallel.sw_sharded import ShardedAlignDB, make_mesh
from spacedust_tpu_torch.search.alignment import (AlignmentEngine,
                                                  AlignmentParams)
from spacedust_tpu_torch.search.prefilter import PrefilterEngine
from spacedust_tpu_torch.stats.submat import load_substitution_matrix
from spacedust_tpu_torch.workflow.clustersearch import ClusterSearchParams

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"
CPU = torch.device("cpu")
KW = dict(cov_thr=0.8, cov_mode=2, same_qt_db=True)


def hits(lists: dict) -> dict:
    return {qk: [(h.seq_id, h.score, h.diagonal) for h in hs]
            for qk, hs in lists.items()}


def tuples(records: dict) -> dict:
    return {qk: [dataclasses.astuple(r) for r in recs]
            for qk, recs in records.items()}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    fastas = synth.write_genome_set(tmp_path_factory.mktemp("small"),
                                    "small")
    return create_setdb_from_fastas(fastas), jax_fastas(fastas)


@pytest.fixture(scope="module")
def single_hits(small):
    db, _ = small
    return PrefilterEngine(db, db, **KW).match_all()


# ------------------------------------------------------------- prefilter
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_prefilter_matches_jax(small, single_hits, n):
    """Equal to the JAX package's concurrent split, list for list; equal
    to the single index's hits as sets (the order of ties inside a list
    is the split's, as in the reference's split mode)."""
    db, jdb = small
    shards = residue_balanced_splits(db.lengths, n)
    got = pipeline.sharded_prefilter(db, db, shards, **KW)
    assert hits(got) == hits(jax_pipeline.sharded_prefilter(
        jdb, jdb, shards, **KW))
    want = hits(single_hits)
    assert list(got) == list(want)
    for qk, lst in hits(got).items():
        assert sorted(lst) == sorted(want[qk]), qk
    stats = pipeline.sharded_prefilter.last_stats
    assert len(stats["index_s"]) == len(stats["probe_s"]) == n
    assert min(stats["bitmap_or_s"], stats["beam_s"], stats["merge_s"]) >= 0


def test_sharded_prefilter_qrange_and_chunks(small):
    """A query range in chunks that do not divide it: the JAX package's
    result for the same range, keyed by exactly those queries."""
    db, jdb = small
    shards = residue_balanced_splits(db.lengths, 3)
    kw = dict(KW, qrange=(37, 251), query_chunk=64)
    got = pipeline.sharded_prefilter(db, db, shards, **kw)
    assert list(got) == list(range(37, 251))
    assert hits(got) == hits(jax_pipeline.sharded_prefilter(
        jdb, jdb, shards, **kw))


# ----------------------------------------------------------- the SW grid
def edge_grid(db, shards, per_shard: int = 6, seed: int = 5):
    """(D, B) forward grid: in every shard its first and last target and
    random others of at most 700 aa, against random queries of at most
    700 aa; shard-local target offsets.  Returns the grid and the token
    bounds."""
    rng = np.random.default_rng(seed)
    short = np.nonzero(db.lengths <= 700)[0]
    toffs = db.offsets
    bounds = [(int(toffs[s]), int(toffs[e])) for s, e in shards]
    grid = np.zeros((5, len(shards), per_shard), dtype=np.int64)
    for d, (s, e) in enumerate(shards):
        inner = [k for k in short if s <= k < e]
        tk = np.array([s, e - 1] + list(rng.choice(inner, per_shard - 2)))
        qk = rng.choice(short, per_shard)
        grid[0, d] = db.offsets[qk]
        grid[1, d] = db.lengths[qk]
        grid[2, d] = toffs[tk] - bounds[d][0]
        grid[3, d] = db.lengths[tk]
    return grid, bounds


def test_run_grid_matches_jax(small):
    """ShardedAlignDB.run_grid, forward then reverse from the forward end
    points, on 4 CPU shards equals the JAX package's shard_map over 4 CPU
    devices, pairs at both ends of every shard included; gather_scores
    equals its all_gather."""
    db, _ = small
    shards = residue_balanced_splits(db.lengths, 4)
    grid, bounds = edge_grid(db, shards)
    mat = load_substitution_matrix()
    qdata = np.ascontiguousarray(db.seq_data, dtype=np.uint8)
    qbias = comp_bias_batch(
        qdata, np.ascontiguousarray(db.offsets[:-1], dtype=np.int64),
        np.ascontiguousarray(db.lengths, dtype=np.int32),
        np.ascontiguousarray(mat.sub_int, dtype=np.int32),
        np.ascontiguousarray(mat.p_back, dtype=np.float64))
    ours = ShardedAlignDB(make_mesh(4, CPU), qdata, qbias, qdata, bounds,
                          mat.sub_int)
    theirs = jax_sharded.ShardedAlignDB(
        jax_sharded.make_mesh(jax.devices()[:4]), qdata, qbias, qdata,
        bounds, mat.sub_int)
    from spacedust_tpu.ops.sw_engine import bucket_len
    fwd = ours.run_grid(None, *grid, 11, 1, reverse=False)
    jfwd = theirs.run_grid((bucket_len(int(grid[1].max())),
                            bucket_len(int(grid[3].max()))),
                           *grid, 11, 1, reverse=False)
    for a, b in zip(fwd, jfwd):
        assert np.array_equal(a, np.asarray(b))
    score, t_end, q_end = fwd
    assert (score > 0).all()
    rgrid = grid.copy()
    rgrid[1], rgrid[3], rgrid[4] = q_end + 1, t_end + 1, score
    rev = ours.run_grid(None, *rgrid, 11, 1, reverse=True)
    jrev = theirs.run_grid((bucket_len(int(rgrid[1].max())),
                            bucket_len(int(rgrid[3].max()))),
                           *rgrid, 11, 1, reverse=True)
    for a, b in zip(rev, jrev):
        assert np.array_equal(a, np.asarray(b))
    assert rev[3].all()                       # every terminate found
    blocks = [torch.from_numpy(r) for r in score]
    assert np.array_equal(ours.gather_scores(blocks),
                          theirs.gather_scores(score))


def test_stream_matches_jax_grid(small):
    """The per-card dispatch of enqueue / flush / collect (the edge grid's
    pairs at global offsets, one stage, shuffled positions) equals the
    JAX package's shard_map (_sharded_bucket_fn through its run_grid)
    on the same pairs, forward and reverse."""
    db, _ = small
    shards = residue_balanced_splits(db.lengths, 4)
    grid, bounds = edge_grid(db, shards, seed=17)
    mat = load_substitution_matrix()
    qbias = np.zeros(len(db.seq_data), np.int8)
    ours = ShardedAlignDB(make_mesh(4, CPU), db.seq_data, qbias,
                          db.seq_data, bounds, mat.sub_int)
    theirs = jax_sharded.ShardedAlignDB(
        jax_sharded.make_mesh(jax.devices()[:4]), db.seq_data, qbias,
        db.seq_data, bounds, mat.sub_int)
    from spacedust_tpu.ops.sw_engine import bucket_len
    starts = np.array([s for s, _ in bounds])[:, None]
    rng = np.random.default_rng(4)

    def stream(g, reverse):
        cols = [g[0], g[1], g[2] + starts, g[3], g[4]]
        cols = [c.reshape(-1) for c in cols]
        pos = rng.permutation(len(cols[0]))
        out = np.zeros((6, len(pos)), np.int64)
        for p, c in ours.run_buckets([(*cols, pos)], 11, 1, reverse):
            out[:, p] = np.stack(c)
        return out[:, pos].reshape(6, *g.shape[1:])

    def jax_grid(g, reverse):
        return theirs.run_grid((bucket_len(int(g[1].max())),
                                bucket_len(int(g[3].max()))), *g, 11, 1,
                               reverse=reverse)

    fwd = stream(grid, False)
    for i, b in enumerate(jax_grid(grid, False)):
        assert np.array_equal(fwd[i], np.asarray(b))
    rgrid = grid.copy()
    rgrid[1], rgrid[3], rgrid[4] = fwd[2] + 1, fwd[1] + 1, fwd[0]
    rev = stream(rgrid, True)
    for i, b in zip((0, 4, 5, 3), jax_grid(rgrid, True)):
        assert np.array_equal(rev[i], np.asarray(b))
    assert rev[3].all()
    assert ours.metrics["stages"] == 2


def test_stream_puts_results_back_in_job_order(small):
    """The DeviceAlignDB stream over shards: jobs with global target
    offsets, split by shard, give every job its single-engine result
    under its own position; a masked copy of the targets is sharded at
    its target starts."""
    db, _ = small
    rng = np.random.default_rng(9)
    n = 150
    short = np.nonzero(db.lengths <= 400)[0]
    qk = rng.choice(short, n)
    tk = np.concatenate([[0, db.size - 1], rng.choice(short, n - 2)])
    jobs = [(db.offsets[qk], db.lengths[qk], db.offsets[tk], db.lengths[tk],
             np.full(n, -1), rng.permutation(n))]
    mat = load_substitution_matrix()
    qbias = np.zeros(len(db.seq_data), np.int8)
    from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
    single = DeviceAlignDB(db.seq_data, qbias, db.seq_data, mat.sub_int, CPU)
    toffs = db.offsets
    shards = residue_balanced_splits(db.lengths, 3)
    sharded = ShardedAlignDB(make_mesh(3, CPU), db.seq_data, qbias,
                             db.seq_data,
                             [(int(toffs[s]), int(toffs[e]))
                              for s, e in shards], mat.sub_int)

    def by_pos(collected):
        out = np.zeros((6, n), np.int64)
        for pos, cols in collected:
            out[:, pos] = np.stack(cols)
        return out

    want = by_pos(single.run_buckets(jobs, 11, 1, reverse=False))
    assert np.array_equal(by_pos(sharded.run_buckets(jobs, 11, 1, False)),
                          want)
    m = sharded.metrics
    assert m["shards"] == 3 and m["stages"] == 1 and m["cards"] == 1
    assert sum(m["shard_fwd_pairs"]) == n == m["fwd_pairs"]
    # launches and kernel ms a card, pairs a shard (the plain version
    # launches nothing)
    assert m["card_fwd_launches"] == [0] and m["card_fwd_kernel_ms"] == [0.0]
    assert m["card_rev_block_pairs"] == [0]
    assert not any(k.startswith("shard_") and not k.endswith("_pairs")
                   for k in m)
    # masked-copy targets (the --alt-ali rounds), cut at their starts
    tl = db.lengths[tk].astype(np.int64)
    starts = np.cumsum(tl) - tl
    copy = np.concatenate([db.sequence(int(k)) for k in tk])
    view = sharded.with_targets(copy, starts)
    assert view.n_shards == 3
    assert view.tok_starts[0] == 0 and set(view.tok_starts) <= set(starts)
    # its own shards and pointer table, the resident queries shared
    assert view.targets[0].tensors == view.tparts
    assert all(a is b for a, b in zip(view.queries[CPU],
                                      sharded.queries[CPU]))
    jobs2 = [(db.offsets[qk], db.lengths[qk], starts, tl, np.full(n, -1),
              np.arange(n))]
    assert np.array_equal(by_pos(view.run_buckets(jobs2, 11, 1, False)),
                          by_pos(single.with_targets(copy).run_buckets(
                              jobs2, 11, 1, False)))


def test_stage_without_jobs_on_the_first_shard(small):
    """A stage whose targets all lie in the later shards, forward and then
    reverse from its end points: the first shard gets no pair, every
    job gets the single engine's result under its own position, and the
    stage is counted (on a card its wall time comes from events on the
    first card's stream, which no shard of this stage fetched from)."""
    db, _ = small
    rng = np.random.default_rng(11)
    n = 40
    shards = residue_balanced_splits(db.lengths, 3)
    short = np.nonzero(db.lengths <= 400)[0]
    qk = rng.choice(short, n)
    tk = np.concatenate([[shards[1][0], db.size - 1],
                         rng.choice(short[short >= shards[1][0]], n - 2)])
    mat = load_substitution_matrix()
    qbias = np.zeros(len(db.seq_data), np.int8)
    from spacedust_tpu_torch.ops.sw_engine import DeviceAlignDB
    single = DeviceAlignDB(db.seq_data, qbias, db.seq_data, mat.sub_int, CPU)
    toffs = db.offsets
    sharded = ShardedAlignDB(make_mesh(3, CPU), db.seq_data, qbias,
                             db.seq_data,
                             [(int(toffs[s]), int(toffs[e]))
                              for s, e in shards], mat.sub_int)

    def by_pos(collected):
        out = np.zeros((6, n), np.int64)
        for pos, cols in collected:
            out[:, pos] = np.stack(cols)
        return out

    perm = rng.permutation(n)
    fwd = [(db.offsets[qk], db.lengths[qk], db.offsets[tk], db.lengths[tk],
            np.full(n, -1), perm)]
    want = by_pos(single.run_buckets(fwd, 11, 1, reverse=False))
    got = by_pos(sharded.collect(sharded.enqueue(fwd, 11, 1, False)
                                 + sharded.flush(11, 1, False)))
    assert np.array_equal(got, want)
    score, t_end, q_end = want[:3, perm]
    rev = [(db.offsets[qk], q_end + 1, db.offsets[tk], t_end + 1, score,
            np.arange(n))]
    want = by_pos(single.run_buckets(rev, 11, 1, reverse=True))
    assert np.array_equal(by_pos(sharded.run_buckets(rev, 11, 1, True)),
                          want)
    assert want[3].all()                      # every terminate found
    m = sharded.metrics
    assert m["stages"] == 2
    assert m["shard_fwd_pairs"][0] == m["shard_rev_pairs"][0] == 0
    assert min(m["shard_fwd_pairs"][1:] + m["shard_rev_pairs"][1:]) > 0


def test_make_mesh():
    assert make_mesh(3, "cpu") == [CPU] * 3
    assert make_mesh(None, "cpu") == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_mesh(2, "cuda")


# --------------------------------------------------------- search stage
def test_sharded_search_matches_jax(small):
    db, jdb = small
    got = pipeline.sharded_search(db, db, n_shards=4, device=CPU)
    want = jax_pipeline.sharded_search(
        jdb, jdb, mesh=jax_sharded.make_mesh(jax.devices()[:4]))
    assert tuples(got) == tuples(want)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    fastas = synth.write_genome_set(tmp_path_factory.mktemp("tiny"),
                                    "repeats_tiny")
    db = create_setdb_from_fastas(fastas)
    cands = {qk: [h.seq_id for h in hs]
             for qk, hs in PrefilterEngine(db, db).match_all().items()}
    return db, cands


@pytest.mark.parametrize("controls", [
    dict(max_accept=3, max_rejected=2, alt_alignments=2),
    dict(alt_alignments=2), dict(max_accept=1)],
    ids=["accept-rejected-alt", "alt", "accept"])
def test_sharded_engine_keeps_the_controls(tiny, controls):
    """--max-accept / --max-rejected / --alt-ali on the sharded engine
    (the masked rounds sharded too) give the single engine's records."""
    db, cands = tiny
    par = AlignmentParams(**controls)
    want = AlignmentEngine(db, db, par, device=CPU).align_all(cands)
    shards = residue_balanced_splits(db.lengths, 3)
    eng = pipeline.ShardedAlignmentEngine(db, db, par, make_mesh(3, CPU),
                                          shards)
    got = eng.align_all(cands)
    assert tuples(got) == tuples(want)
    if par.alt_alignments:
        assert eng.alt_metrics["round_pairs"]
    assert eng._device_db().metrics["shards"] == 3


def test_sharded_cluster_search_equals_fixture(small):
    db, _ = small
    res = pipeline.sharded_cluster_search(
        db, db, ClusterSearchParams(filter_self_match=True), n_shards=4,
        device=CPU)
    assert res.tsv == (FIXTURES / "torch_port_small.tsv").read_text()
    detail = res.timings["search_detail"]
    assert detail["align_detail"]["shards"] == 4
    assert len(detail["prefilter_detail"]["probe_s"]) == 4


@pytest.mark.parametrize("change", [
    dict(profile_cluster_search=True), dict(search_mode=2),
    dict(split_memory_limit=1000), dict(kmer_size=5)],
    ids=["profile", "structure", "split", "kmer"])
def test_cluster_search_shards_only_the_sequence_search(small, change):
    """cluster_search takes target shards on the sequence search alone:
    the other paths, and -k, which the split prefilter does not take,
    are refused before any work."""
    from spacedust_tpu_torch.workflow.clustersearch import cluster_search
    db, _ = small
    with pytest.raises(ValueError, match="target shards serve"):
        cluster_search(db, db, ClusterSearchParams(**change), device=CPU,
                       shard_devices=make_mesh(2, CPU))
