"""Ingest and prefilter of the port against the JAX package, on the
small synthetic genome set: SetDB arrays, PrefilterEngine.match_range
hits, and SetDB directories read across the two packages."""

import numpy as np
import pytest

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.db.setdb import SetDB as JaxSetDB
from spacedust_tpu.search.prefilter import PrefilterEngine as JaxPrefilter
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.db.setdb import SetDB
from spacedust_tpu_torch.search.prefilter import PrefilterEngine


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
