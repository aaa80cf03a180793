"""The out-of-core target split of the port (clustersearch
--split-memory-limit) against the JAX package on the same inputs: the
zero-copy SetDB range, the residue-balanced splits and the memory-budget
split count, the shard merge, the sequential split prefilter and the query
split, and the whole clustersearch (sequence and --profile-cluster-search,
SW on the CPU, plain version) against the unsplit fixtures.  Equal, not
close; inputs made from seeds."""

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.parallel import merge as jax_merge
from spacedust_tpu.parallel import pipeline as jax_pipeline
from spacedust_tpu.parallel import split as jax_split
from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.parallel import merge, pipeline, split
from spacedust_tpu_torch.search.profilesearch import profile_slices
from spacedust_tpu_torch.workflow.clusterdb import ClusterDB

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"


def hits(lists: dict) -> dict:
    return {qk: [(h.seq_id, h.score, h.diagonal) for h in hs]
            for qk, hs in lists.items()}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    fastas = synth.write_genome_set(d, "small")
    db = str(d / "db")
    assert cli.main(["createsetdb", *map(str, fastas), db]) == 0
    return create_setdb_from_fastas(fastas), jax_fastas(fastas), db


# ---------------------------------------------------------------- setdb
def test_subrange_is_a_view(small, tmp_path):
    db, jdb, _ = small
    for s, e in ((0, 1), (17, 140), (150, db.size), (0, db.size)):
        sub, jsub = db.subrange(s, e), jdb.subrange(s, e)
        assert sub.size == jsub.size == e - s
        assert np.shares_memory(sub.seq_data, db.seq_data)
        for name in ("seq_data", "offsets", "set_ids", "pos_idx", "starts",
                     "ends", "lengths"):
            assert np.array_equal(getattr(sub, name), getattr(jsub, name))
        assert sub.names == jsub.names and sub.headers == jsub.headers
        for k in (0, e - s - 1):
            assert np.array_equal(sub.sequence(k), db.sequence(s + k))
    # the 3Di sidecar comes along, as a view
    base, _ref = synth.write_struct_set(tmp_path / "st", "small")
    from spacedust_tpu_torch.db.flatdb_ingest import create_setdb_from_flatdb
    sdb = create_setdb_from_flatdb(base)
    sub = sdb.subrange(10, 20)
    assert sub.has_ss and np.shares_memory(sub.ss_data, sdb.ss_data)
    assert np.array_equal(sub.ss_sequence(3), sdb.ss_sequence(13))


# ---------------------------------------------------------------- splits
@pytest.mark.parametrize("seed", range(4))
def test_splits_match_jax(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3000, int(rng.integers(1, 400)))
    total = int(lengths.sum())
    for n in (1, 2, 3, 7, len(lengths), len(lengths) + 5):
        got = split.residue_balanced_splits(lengths, n)
        assert got == jax_split.residue_balanced_splits(lengths, n)
        assert got[0][0] == 0 and got[-1][1] == len(lengths)
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(got,
                                                                got[1:]))
    for budget in (1, 12, 12 * 500, 12 * total // 3, 12 * total,
                   10 ** 12):
        got = split.splits_for_memory_budget(lengths, budget)
        assert got == jax_split.splits_for_memory_budget(lengths, budget)


def test_budget_split_counts_on_small(small):
    db, _jdb, _ = small
    assert len(split.splits_for_memory_budget(db.lengths, 400_000)) == 4
    assert len(split.splits_for_memory_budget(db.lengths, 150_000)) == 9


# ----------------------------------------------------------------- merge
@pytest.mark.parametrize("same_qt_db", [False, True])
@pytest.mark.parametrize("cov_thr,cov_mode", [(0.0, 0), (0.8, 0), (0.5, 2),
                                              (0.7, 5)])
def test_merge_shard_hits_matches_jax(same_qt_db, cov_thr, cov_mode):
    rng = np.random.default_rng(int(cov_thr * 10) + cov_mode
                                + 100 * same_qt_db)
    nq, nt, n_shards, max_seqs = 40, 300, 4, 25
    qlens = rng.integers(30, 800, nq)
    tlens = rng.integers(30, 800, nt)
    parts = []
    for si in range(n_shards):
        lo, hi = si * nt // n_shards, (si + 1) * nt // n_shards
        for q in range(5, 35):             # a query range inside [0, nq)
            n = int(rng.integers(0, max_seqs + 1))
            seq = rng.choice(np.arange(lo, hi), n, replace=False)
            # scores: saturating (255+), ties, and below min_diag_score
            score = rng.choice([3, 15, 40, 40, 100, 255, 300], n)
            parts.append((np.full(n, q), seq, score,
                          rng.integers(0, 65536, n),
                          si * max_seqs + np.arange(n)))
    arrays = [np.concatenate([p[i] for p in parts]).astype(np.int64)
              for i in range(5)]
    args = (*arrays, 5, 35, qlens, tlens, max_seqs, 15, cov_thr, cov_mode,
            same_qt_db)
    got, want = merge.merge_shard_hits(*args), jax_merge.merge_shard_hits(
        *args)
    assert hits(got) == hits(want)
    assert list(got) == list(range(5, 35))
    assert max(len(v) for v in got.values()) == max_seqs or cov_thr > 0
    # an empty merge keeps the identity slots
    empty = [np.empty(0, np.int64)] * 5
    got = merge.merge_shard_hits(*empty, 0, 3, qlens, tlens, max_seqs, 15,
                                 cov_thr, cov_mode, same_qt_db)
    assert hits(got) == hits(jax_merge.merge_shard_hits(
        *empty, 0, 3, qlens, tlens, max_seqs, 15, cov_thr, cov_mode,
        same_qt_db))


# ------------------------------------------------------- split prefilter
@pytest.mark.parametrize("budget", [400_000, 150_000])
def test_sharded_prefilter_matches_jax(small, budget):
    db, jdb, _ = small
    shards = split.splits_for_memory_budget(db.lengths, budget)
    kw = dict(cov_thr=0.8, cov_mode=2, same_qt_db=True, sequential=True)
    got = pipeline.sharded_prefilter(db, db, shards, **kw)
    want = jax_pipeline.sharded_prefilter(jdb, jdb, shards, **kw)
    assert hits(got) == hits(want)
    stats = pipeline.sharded_prefilter.last_stats
    assert len(stats["shard_s"]) == len(shards) and stats["merge_s"] >= 0
    assert sum(len(v) for v in got.values()) > 2 * db.size


def test_concurrent_split_waits_for_a8(small):
    """The concurrent split (ROADMAP A8) is ported: it gives the
    sequential split's hits, and its own timings."""
    db, _jdb, _ = small
    kw = dict(cov_thr=0.8, cov_mode=2, same_qt_db=True)
    shards = [(0, 100), (100, db.size)]
    got = pipeline.sharded_prefilter(db, db, shards, **kw)
    stats = pipeline.sharded_prefilter.last_stats
    assert len(stats["index_s"]) == len(stats["probe_s"]) == 2
    assert hits(got) == hits(pipeline.sharded_prefilter(
        db, db, shards, sequential=True, **kw))


def test_query_split_prefilter_matches_jax(small):
    db, jdb, _ = small
    kw = dict(cov_thr=0.8, cov_mode=2, same_qt_db=True)
    got = pipeline.query_split_prefilter(db, db, 3, **kw)
    assert hits(got) == hits(jax_pipeline.query_split_prefilter(jdb, jdb, 3,
                                                                **kw))
    assert len(pipeline.query_split_prefilter.last_stats["slice_s"]) == 3


# ----------------------------------------------------------- clustersearch
@pytest.mark.parametrize("budget", [400_000, 150_000])
def test_cli_split_equals_unsplit_fixture(small, tmp_path, budget):
    _db, _jdb, db = small
    out = tmp_path / "out.tsv"
    assert cli.main(["clustersearch", db, db, str(out), "--filter-self-match",
                     "--split-memory-limit", str(budget),
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == (FIXTURES / "torch_port_small.tsv").read_bytes()


def test_cli_profile_slices_equal_unsplit_fixture(small, tmp_path):
    _db, _jdb, db = small
    clu = FIXTURES / "torch_port_small_clu"
    budget = 64_000_000
    assert 3 <= len(profile_slices(ClusterDB.load(clu), budget)) <= 4
    out = tmp_path / "out.tsv"
    assert cli.main(["clustersearch", db, db, str(out), "--filter-self-match",
                     "--profile-cluster-search", "--cluster-db", str(clu),
                     "--split-memory-limit", str(budget),
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == (FIXTURES
                                / "torch_port_small_profile.tsv").read_bytes()


@pytest.mark.parametrize("flag,value", [("-k", "7"),
                                        ("--spaced-kmer-mode", "0"),
                                        ("--search-mode", "2")])
def test_cli_refuses_flags_the_split_drops(tmp_path, capsys, flag, value):
    """The JAX package's split path ignores these flags; the port refuses
    them at parse time, naming the flag."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["clustersearch", "q", "q", str(tmp_path / "o.tsv"),
                  "--split-memory-limit", "1000000", flag, value])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "--split-memory-limit" in err
