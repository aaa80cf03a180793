"""The port's structure search (--search-mode 1/2, aa2foldseek) against
the JAX package on the CPU: the plain version of the two-channel SW
(ops/sw.py::sw_struct_jobs_ref) against the XLA program
_sw_bucket_struct, the combined matrices, the flat-DB ingest, the
alignment records of structure_search, the aa2foldseek mapping and mode 1,
and the CLI against the fixtures the JAX package recorded
(tools/record_torch_port_fixtures.py).  Every comparison is exact."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacedust_tpu.db.flatdb_ingest import (
    create_setdb_from_flatdb as jax_flatdb)
from spacedust_tpu.ops.sw_engine import _sw_bucket_struct
from spacedust_tpu.search.structure import (
    combined_matrices as jax_combined, structure_search as jax_structure)
from spacedust_tpu.workflow.aa2foldseek import (
    StructureRef as JaxStructureRef, aa2foldseek as jax_aa2foldseek)
from spacedust_tpu.workflow.clustersearch import ClusterSearchParams as JaxCSP
from spacedust_tpu.workflow.clustersearch import cluster_search as jax_search
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.cluster.summarize import canonical_blocks
from spacedust_tpu_torch.ops.sw import (REF_CELLS, REF_CELLS_CUDA,
                                        _job_batches, sw_struct_jobs_ref)
from spacedust_tpu_torch.search.structure import (combined_matrices,
                                                  structure_search)
from spacedust_tpu_torch.workflow.aa2foldseek import StructureRef, aa2foldseek
from spacedust_tpu_torch.workflow.clustersearch import (ClusterSearchParams,
                                                        cluster_search)
from spacedust_tpu_torch.workflow.createsetdb import create_setdb

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = {2: ROOT / "tests" / "fixtures" / "torch_port_struct_small.tsv",
            1: ROOT / "tests" / "fixtures"
            / "torch_port_struct_small_mode1.tsv"}
GO, GE = 10, 1

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def struct_set(tmp_path_factory):
    """(flat DB base, reference structure DB base) of the small set."""
    return synth.write_struct_set(tmp_path_factory.mktemp("struct"), "small")


@pytest.fixture(scope="module")
def subsets(struct_set):
    """Port and JAX SetDBs of 40 consecutive genes of each genome around
    the first conserved block of the mode-2 fixture (consecutive posIdx
    runs, so neighbourhood clustering has material)."""
    db, jdb = create_setdb([str(struct_set[0])]), jax_flatdb(struct_set[0])
    first = FIXTURES[2].read_text().split("#")[1].splitlines()[1]
    keys = []
    for set_id, name in enumerate(first[1:].split("\t")[:2]):
        lo = max(int(name.split("_")[-3]) - 10, 0)
        keys += [k for k in range(db.size) if db.set_ids[k] == set_id
                 and lo <= db.pos_idx[k] < lo + 40]
    return db.subset(keys), jdb.subset(keys)


# ------------------------------------------------------------ the SW pass
def _struct_batch(seed: int, B: int = 24, Lq: int = 128, Lt: int = 256):
    """Resident 3Di / amino-acid / bias arrays and a (5, B) job array:
    ragged lengths up to (Lq, Lt), homologs (kept 3Di, remote amino
    acids), a length-1 pair, a pair whose bias makes every cell negative,
    and 3Di bias at -128..127 on a quarter of the pairs (the 3Di channel
    wraps int8)."""
    rng = np.random.default_rng(seed)
    ql = rng.integers(2, Lq + 1, B)
    tl = rng.integers(2, Lt + 1, B)
    ql[1] = tl[1] = 1
    qss, qaa, bias, tss, taa = [], [], [], [], []
    for p in range(B):
        s = rng.integers(0, 21, ql[p]).astype(np.uint8)
        a = rng.integers(0, 21, ql[p]).astype(np.uint8)
        b = rng.integers(-3, 4, ql[p]).astype(np.int8)
        if p % 4 == 3:
            b = rng.integers(-128, 128, ql[p]).astype(np.int8)
        elif p == 2:
            b[:] = -100
        if p % 3 == 0:
            n = min(int(tl[p]), int(ql[p]))
            t_s, t_a = s[:n].copy(), a[:n].copy()
            k = rng.integers(0, 100, n) < 25
            t_s[k] = rng.integers(0, 20, int(k.sum()))
            k = rng.integers(0, 100, n) < 60
            t_a[k] = rng.integers(0, 20, int(k.sum()))
        else:
            t_s = rng.integers(0, 21, tl[p]).astype(np.uint8)
            t_a = rng.integers(0, 21, tl[p]).astype(np.uint8)
        qss.append(s)
        qaa.append(a)
        bias.append(b)
        tss.append(t_s)
        taa.append(t_a)
    qlen = np.array([len(x) for x in qss])
    tlen = np.array([len(x) for x in tss])
    jobs = np.stack([np.concatenate(([0], np.cumsum(qlen)[:-1])), qlen,
                     np.concatenate(([0], np.cumsum(tlen)[:-1])), tlen,
                     np.full(B, -1)]).astype(np.int64)
    arrays = [np.concatenate(x) for x in (qss, qaa, bias, tss, taa)]
    return arrays, jobs


def _jax_struct(arrays, jobs, reverse: bool, Lq: int = 128, Lt: int = 256):
    qss, qaa, bias, tss, taa = arrays
    m3di, aasc, _ = jax_combined()
    params = np.concatenate([jobs, np.full((1, jobs.shape[1]), int(reverse))]
                            ).astype(np.int32)
    out = _sw_bucket_struct(
        *(jnp.asarray(a.astype(np.int8)) for a in (qss, qaa, bias, tss, taa)),
        jnp.asarray(m3di), jnp.asarray(aasc), jnp.asarray(params),
        Lq=Lq, Lt=Lt, gap_open=GO, gap_extend=GE)
    return np.stack([np.asarray(x).astype(np.int32) for x in out])


def _port_struct(arrays, jobs, reverse: bool):
    m3di, aasc, _ = combined_matrices()
    qss, qaa, bias, tss, taa = (torch.from_numpy(a) for a in arrays)
    return sw_struct_jobs_ref(
        qss, qaa, bias, tss, taa, torch.from_numpy(m3di.astype(np.int8)),
        torch.from_numpy(aasc.astype(np.int8)), jobs, GO, GE,
        reverse).numpy()


@pytest.mark.parametrize("reverse", [False, True])
def test_struct_ref_matches_jax_bucket(reverse):
    arrays, jobs = _struct_batch(11)
    fwd = _jax_struct(arrays, jobs, False)
    assert fwd[0, 2] == 0 and fwd[1, 2] == -1        # the all-negative pair
    assert (fwd[0] > 0).sum() >= 20
    if reverse:
        # flipped prefixes [0..q_end] x [0..t_end], terminate = the score
        keep = np.nonzero(fwd[0] > 0)[0]
        jobs = np.stack([jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep],
                         fwd[1, keep] + 1, fwd[0, keep]]).astype(np.int64)
    ref = _jax_struct(arrays, jobs, reverse)
    got = _port_struct(arrays, jobs, reverse)
    for i in range(6):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"output {i}")
    if reverse:
        assert ref[3].all()


@pytest.mark.parametrize("tight", [True, False])
def test_job_batches_partition_the_pairs(tight):
    """Both batchings of the plain version (tight boxes on the CPU, few
    wide batches on CUDA) cover every pair once within their cell bound."""
    _arrays, jobs = _struct_batch(5, B=12000, Lq=1500, Lt=900)
    batches = list(_job_batches(jobs, tight))
    np.testing.assert_array_equal(np.sort(np.concatenate(batches)),
                                  np.arange(jobs.shape[1]))
    limit = REF_CELLS if tight else REF_CELLS_CUDA
    assert all(len(b) == 1 or len(b) * jobs[1, b].max() <= limit
               for b in batches)
    assert len(batches) > 1


def test_combined_matrices_match_jax():
    m3di, aasc, gumbel = combined_matrices()
    jm3di, jaasc, jgumbel = jax_combined()
    np.testing.assert_array_equal(m3di, jm3di)
    np.testing.assert_array_equal(aasc, jaasc)
    assert dataclasses.astuple(gumbel) == dataclasses.astuple(jgumbel)
    assert gumbel.K == 300.0 and 0.05 < gumbel.lam < 1.0


# -------------------------------------------------------------- the slice
def test_flatdb_ingest_matches_jax(struct_set):
    db, jdb = create_setdb([str(struct_set[0])]), jax_flatdb(struct_set[0])
    assert db.size == sum(synth.SIZES["small"]) and db.has_ss
    assert (db.names, db.headers, db.sources) == \
        (jdb.names, jdb.headers, jdb.sources)
    for f in ("seq_data", "ss_data", "offsets", "set_ids", "pos_idx",
              "starts", "ends"):
        np.testing.assert_array_equal(getattr(db, f), getattr(jdb, f),
                                      err_msg=f)
    assert db.sources == ["genome_a.faa", "genome_b.faa"]
    assert int(db.lengths.max()) <= synth.STRUCT_MAX_LEN


def test_structure_search_matches_jax(subsets):
    db, jdb = subsets
    metrics: dict = {}
    t0 = time.perf_counter()
    got = structure_search(db, db, device="cpu", metrics=metrics)
    elapsed = time.perf_counter() - t0
    # the host clock of the three steps, beside the SW engine's metrics
    split = [metrics[k] for k in ("index_s", "prefilter_s", "align_all_s")]
    assert min(split) > 0 and sum(split) <= elapsed
    assert metrics["fwd_pairs"] > 0
    ref = jax_structure(jdb, jdb)
    assert list(got) == list(ref)
    n = 0
    for qk in ref:
        assert ([dataclasses.astuple(r) for r in got[qk]]
                == [dataclasses.astuple(r) for r in ref[qk]]), qk
        assert [r.line() for r in got[qk]] == [r.line() for r in ref[qk]]
        n += sum(1 for r in ref[qk] if r.tkey != qk)
    assert n >= 10                   # non-identity alignments were checked
    # every gene finds itself (identity fast path, int16 raw score)
    assert all(any(r.tkey == qk and r.seq_id == 1.0 for r in got[qk])
               for qk in range(db.size))


def test_aa2foldseek_and_mode1_match_jax(struct_set, subsets):
    db, jdb = subsets
    m = aa2foldseek(db, StructureRef.open(struct_set[1]), device="cpu")
    jm = jax_aa2foldseek(jdb, JaxStructureRef.open(struct_set[1]))
    assert m.mapping == jm.mapping
    assert 0 < len(m.mapping) < db.size
    att, jatt = m.attach(db), jm.attach(jdb)
    np.testing.assert_array_equal(att.seq_data, jatt.seq_data)
    np.testing.assert_array_equal(att.ss_data, jatt.ss_data)
    got = cluster_search(db, db, ClusterSearchParams(
        filter_self_match=True, search_mode=1), query_mapping=m,
        target_mapping=m, device="cpu")
    ref = jax_search(jdb, jdb, JaxCSP(filter_self_match=True, search_mode=1),
                     query_mapping=jm, target_mapping=jm)
    assert canonical_blocks(got.tsv) == canonical_blocks(ref.tsv)
    assert ([dataclasses.astuple(x) for x in got.matches]
            == [dataclasses.astuple(x) for x in ref.matches])
    assert len(got.matches) > 0
    assert got.timings["align_detail"]["fwd_pairs"] > 0
    assert got.timings["unmapped_align_detail"]["fwd_pairs"] > 0


@pytest.mark.parametrize("mode", [2, 1])
def test_cli_matches_fixture(struct_set, tmp_path, mode):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "spacedust_tpu_torch"]
    db, out = str(tmp_path / "db"), str(tmp_path / "result.tsv")
    steps = [["createsetdb", str(struct_set[0]), db]]
    if mode == 1:
        steps.append(["aa2foldseek", db, str(struct_set[1]),
                      "--device", "cpu"])
    steps.append(["clustersearch", db, db, out, str(tmp_path / "tmp"),
                  "--filter-self-match", "--search-mode", str(mode),
                  "--device", "cpu"])
    for args in steps:
        res = subprocess.run(run + args, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
    tsv = Path(out).read_text()
    assert canonical_blocks(tsv) == canonical_blocks(
        FIXTURES[mode].read_text())
    lines = tsv.splitlines()
    assert sum(1 for ln in lines if ln.startswith(">")) >= 20
    assert sum(1 for ln in lines if ln.startswith("#")) >= 3


def test_unported_options_still_raise(subsets):
    db, _ = subsets
    with pytest.raises(ValueError, match="aa2foldseek"):
        cluster_search(db, db, ClusterSearchParams(search_mode=1),
                       device="cpu")
    # out-of-core splits are ported for the sequence and the profile
    # search, not for the structure search: the JAX package ignores the
    # split there, and the port's CLI refuses the pair at parse time
    from spacedust_tpu_torch import cli
    with pytest.raises(SystemExit) as exc:
        cli.main(["clustersearch", "q", "q", "o", "--search-mode", "2",
                  "--split-memory-limit", str(1 << 20)])
    assert exc.value.code == 2


def test_profile_cache_is_bounded(subsets):
    """The structure engine keeps the last few (L, 441) query profiles for
    its tracebacks and builds none for the identity records."""
    from spacedust_tpu_torch.search.alignment import AlignmentParams
    from spacedust_tpu_torch.search.structure import (
        PROFILE_CACHE, StructureAlignmentEngine)
    db, _ = subsets
    eng = StructureAlignmentEngine(db, db, AlignmentParams(gap_open=10),
                                   same_qt_db=True, device="cpu")
    keys = list(range(PROFILE_CACHE + 3))
    want = [eng._combined_profile(k).copy() for k in keys]
    assert list(eng._prof_cache) == keys[-PROFILE_CACHE:]
    for k in reversed(keys):             # rebuilt after eviction: the same
        np.testing.assert_array_equal(eng._combined_profile(k), want[k])
    eng._prof_cache.clear()
    rec = eng._identity_record(0)
    assert not eng._prof_cache
    sym = eng._target_symbols(0).astype(np.int64)
    raw = int(np.int16(want[0][np.arange(len(sym)), sym].astype(
        np.int64).sum()))
    assert rec.raw_score == raw and rec.backtrace == "M" * len(sym)
