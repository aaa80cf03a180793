"""Ingest and prefilter of the port against the JAX package, on the
small synthetic genome set: SetDB arrays, PrefilterEngine.match_range
hits, SetDB directories read across the two packages, and the target
k-mer index (postings, masked residues, every k-mer's posting range
through the port's hash), at several OpenMP team sizes and through a
save and load."""

import numpy as np
import pytest

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.db.setdb import SetDB as JaxSetDB
from spacedust_tpu.db.flatdb_ingest import (
    create_setdb_from_flatdb as jax_flatdb)
from spacedust_tpu.search.prefilter import KmerIndex as JaxKmerIndex
from spacedust_tpu.search.prefilter import PrefilterEngine as JaxPrefilter
from spacedust_tpu_torch import native, synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.db.flatdb_ingest import create_setdb_from_flatdb
from spacedust_tpu_torch.db.setdb import SetDB
from spacedust_tpu_torch.search.prefilter import (
    KmerIndex, PrefilterEngine, kmer_pattern, kmer_score_threshold)
from spacedust_tpu_torch.stats.submat import load_pinned_matrix
from spacedust_tpu_torch.utils import trace


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    return synth.write_genome_set(tmp_path_factory.mktemp("small"), "small")


def _same_db(a, b):
    np.testing.assert_array_equal(a.seq_data, b.seq_data)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.set_ids, b.set_ids)
    np.testing.assert_array_equal(a.pos_idx, b.pos_idx)
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    assert (a.names, a.headers, a.sources, a.dbtype) == \
        (b.names, b.headers, b.sources, b.dbtype)


def test_setdb_matches_jax(fastas):
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    assert db.size == 300 and db.num_sets == 2
    _same_db(db, jdb)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_setdb_round_trip(fastas, tmp_path, writer):
    """A directory saved by one package loads in the other."""
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    if writer == "jax":
        jdb.save(tmp_path / "db")
        _same_db(SetDB.load(tmp_path / "db"), jdb)
    else:
        db.save(tmp_path / "db")
        _same_db(JaxSetDB.load(tmp_path / "db"), db)


@pytest.mark.parametrize("cov", [(0.0, 0), (0.8, 2)])
def test_match_range_matches_jax(fastas, cov):
    db, jdb = create_setdb_from_fastas(fastas), jax_fastas(fastas)
    kw = dict(sensitivity=5.7, max_seqs=300, cov_thr=cov[0], cov_mode=cov[1])
    pref = PrefilterEngine(db, db, **kw)
    jpref = JaxPrefilter(jdb, jdb, **kw)
    n_hits = 0
    for s, e in ((0, 120), (120, 300)):
        got, ref = pref.match_range(s, e), jpref.match_range(s, e)
        assert list(got) == list(ref)
        for qk in ref:
            g = [(h.seq_id, h.score, h.diagonal) for h in got[qk]]
            r = [(h.seq_id, h.score, h.diagonal) for h in ref[qk]]
            assert g == r, qk
            n_hits += len(r)
    assert n_hits > db.size          # identity plus homolog hits


# ------------------------------------------------------------ k-mer index
THR6, THR7 = kmer_score_threshold(5.7, 6), kmer_score_threshold(5.7, 7)
# (case, index keyword arguments); "3di" indexes the structure set's 3Di
# states as the structure search does
INDEX_CASES = [
    ("mask_k6", dict(kmer_thr=THR6)),
    ("nomask_k6", dict(kmer_thr=THR6, mask=False)),
    ("mask_k7", dict(kmer_thr=THR7, kmer_size=7)),
    ("consecutive_k6", dict(kmer_thr=THR6, pattern=kmer_pattern(6, False))),
    ("consecutive_k7", dict(kmer_thr=THR7, kmer_size=7,
                            pattern=kmer_pattern(7, False))),
    ("profile_thr0", dict(kmer_thr=0)),
    ("3di", dict(kmer_thr=118, seed_name="mat3di_bf8_bias")),
]


@pytest.fixture(scope="module")
def struct_dbs(tmp_path_factory):
    base, _ref = synth.write_struct_set(tmp_path_factory.mktemp("struct"),
                                        "small")
    return (create_setdb_from_flatdb(base).ss_view(),
            jax_flatdb(base).ss_view())


def _dbs(case, fastas, struct_dbs):
    if case == "3di":
        return struct_dbs
    return create_setdb_from_fastas(fastas), jax_fastas(fastas)


def _seeded(kw):
    kw = dict(kw)
    name = kw.pop("seed_name", None)
    if name is not None:
        kw["seed_matrix"] = load_pinned_matrix(name)
    return kw


def _build(cls, db, kw):
    return cls(db, **_seeded(kw))


def _ranges(idx, keys):
    """(offset, count) of each k-mer of `keys` through the index's hash
    (the native engine's probe; (-1, 0) for a k-mer it does not hold)."""
    keys = np.asarray(keys, dtype=np.int64)
    mask = len(idx.hkeys) - 1
    slot = ((keys * 2654435761) & 0xFFFFFFFF) & mask
    off = np.full(len(keys), -1, np.int64)
    cnt = np.zeros(len(keys), np.int64)
    todo = np.arange(len(keys))
    while len(todo):
        k = idx.hkeys[slot[todo]]
        hit = k == keys[todo]
        off[todo[hit]] = idx.hoff[slot[todo[hit]]]
        cnt[todo[hit]] = idx.hcnt[slot[todo[hit]]]
        todo = todo[~hit & (k >= 0)]
        slot[todo] = (slot[todo] + 1) & mask
    return off, cnt


def _same_index(a, b):
    """Two port indexes hold the same postings, residues, bitmap and
    per-k-mer ranges (the hash's slot layout may differ)."""
    for name in ("kmers", "seq_ids", "positions", "t_data", "t_offsets",
                 "occupied"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert len(a.hkeys) == len(b.hkeys)
    keys = np.unique(a.kmers)
    assert (a.hkeys >= 0).sum() == (b.hkeys >= 0).sum() == len(keys)
    for x, y in zip(_ranges(a, keys), _ranges(b, keys)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case,kw", INDEX_CASES, ids=[c for c, _ in INDEX_CASES])
def test_kmer_index_matches_jax(fastas, struct_dbs, case, kw):
    """The port's index equals the JAX package's: the postings in
    (kmer, seq, pos) order, the masked residues and their offsets, and
    every k-mer's posting range through the port's hash; the hash holds
    no other key, and the bitmap marks exactly the posted k-mers."""
    db, jdb = _dbs(case, fastas, struct_dbs)
    idx, ref = _build(KmerIndex, db, kw), _build(JaxKmerIndex, jdb, kw)
    for name in ("kmers", "seq_ids", "positions", "t_data", "t_offsets"):
        np.testing.assert_array_equal(getattr(idx, name), getattr(ref, name),
                                      err_msg=name)
    assert idx.kmers.dtype == np.int32 and idx.t_offsets.dtype == np.int64
    assert len(idx.kmers) > 1000
    if kw.get("mask", True):
        assert (idx.t_data != db.seq_data).any()      # something masked
    keys = np.unique(ref.kmers)
    lo, hi = ref.lookup_ranges(keys)
    off, cnt = _ranges(idx, keys)
    np.testing.assert_array_equal(off, lo)
    np.testing.assert_array_equal(cnt, hi - lo)
    assert (idx.hkeys >= 0).sum() == len(keys)
    assert len(idx.hkeys) >= 2 * len(keys)
    bits = np.unpackbits(idx.occupied.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(np.flatnonzero(bits), keys)
    np.testing.assert_array_equal(idx.occupied, ref.occupied)
    for got, want in zip(idx.masked[:50], ref.masked[:50]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["mask_k6", "profile_thr0", "3di", "tiny"])
def test_kmer_index_same_at_every_team_size(fastas, struct_dbs, case):
    """The index is the same whatever the calling thread's OpenMP team
    (set as --threads sets it); "tiny" has fewer sequences than threads,
    two of them shorter than a k-mer's span.  The postings span names
    the team."""
    kw = dict(INDEX_CASES)["mask_k6" if case == "tiny" else case]
    db = _dbs(case, fastas, struct_dbs)[0]
    if case == "tiny":
        db = db.subset([0, 1, 2])
        db.offsets = np.array([0, 5, 9, len(db.seq_data)], np.int64)
    built = {}
    try:
        for n in (1, 3, 8):
            native.set_num_threads(n)
            trace.start()
            built[n] = _build(KmerIndex, db, kw)
            rec = trace.stop()
            (sp,) = [s for s in rec.spans
                     if s[0] == "prefilter.index_postings"]
            assert sp[4] == {"postings": len(built[n].kmers), "threads": n}
    finally:
        native.set_num_threads(0)
    assert len(built[1].kmers) > 0
    _same_index(built[1], built[3])
    _same_index(built[1], built[8])


@pytest.mark.parametrize("case", ["mask_k6", "3di"])
def test_kmer_index_save_load(fastas, struct_dbs, tmp_path, case):
    """A saved index loads with the same arrays and ranges."""
    kw = dict(INDEX_CASES)[case]
    db = _dbs(case, fastas, struct_dbs)[0]
    idx = _build(KmerIndex, db, kw)
    idx.save(tmp_path / "idx.npz")
    got = KmerIndex.load(tmp_path / "idx.npz", db, **_seeded(kw))
    assert got is not None
    _same_index(idx, got)
    assert [m.tolist() for m in got.masked] == [
        m.tolist() for m in idx.masked]


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_kmer_hash_runs_across_shares(threads):
    """Runs of one k-mer up to 400 postings long, so that the threads'
    shares of the posting column start inside runs: every k-mer is in
    the hash once, with its whole range, and in the bitmap."""
    rng = np.random.default_rng(threads)
    keys = np.unique(rng.integers(0, 20 ** 6, 3000)).astype(np.int32)
    runs = rng.integers(1, 400, len(keys))
    runs[::7] = 1
    column = np.repeat(keys, runs)
    try:
        native.set_num_threads(threads)
        hkeys, hoff, hcnt, bitmap, unique = native.build_kmer_hash(
            column, 20 ** 6)
    finally:
        native.set_num_threads(0)
    assert unique == len(keys) and (hkeys >= 0).sum() == len(keys)
    idx = type("Hash", (), dict(hkeys=hkeys, hoff=hoff, hcnt=hcnt))
    off, cnt = _ranges(idx, keys)
    np.testing.assert_array_equal(off, np.cumsum(runs) - runs)
    np.testing.assert_array_equal(cnt, runs)
    bits = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(np.flatnonzero(bits), keys)
