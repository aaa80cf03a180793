"""The port's structure search (--search-mode 1/2, aa2foldseek) against
the JAX package on the CPU: the plain version of the two-channel SW
(ops/sw.py::sw_struct_jobs_ref) against the XLA program
_sw_bucket_struct, the combined matrices, the flat-DB ingest, the
alignment records of structure_search, the aa2foldseek mapping and mode 1,
and the CLI against the fixtures the JAX package recorded
(tools/record_torch_port_fixtures.py).  The batched traceback
(native banded_align_struct_batch) is held against one
banded_align_profile_u16 call a pair over the (441, L) combined profile.
Every comparison is exact."""

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
from spacedust_tpu_torch.native import (banded_align_profile_u16,
                                        banded_align_struct_batch,
                                        set_num_threads)
from spacedust_tpu_torch.ops.sw import (REF_CELLS, REF_CELLS_CUDA,
                                        _job_batches, sw_struct_jobs_ref)
from spacedust_tpu_torch.search import structure as port_structure
from spacedust_tpu_torch.search.alignment import AlignmentParams
from spacedust_tpu_torch.search.structure import (COMBINED_ALPHA,
                                                  StructureAlignmentEngine,
                                                  combined_matrices,
                                                  structure_search)
from spacedust_tpu_torch.utils import trace
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


def _engine(db, **kw) -> StructureAlignmentEngine:
    return StructureAlignmentEngine(
        db, db, AlignmentParams(gap_open=GO, gap_extend=GE, **kw),
        same_qt_db=True, device="cpu")


def test_profile_cache_is_bounded(subsets, traced_search):
    """The structure engine keeps no per-query profile: its traceback
    reads the two 21x21 tables, and its identity record is the int16 sum
    of the combined scores on the pair's diagonal, built here."""
    db, _ = subsets
    eng = _engine(db)
    m3di, aasc, _ = combined_matrices()
    bias = eng._ss_bias_all().astype(np.int64)
    longest = int(np.argmax(db.lengths))
    for k in sorted({0, 1, longest}):
        ss = db.ss_sequence(k).astype(np.int64)
        aa = db.sequence(k).astype(np.int64)
        diag = (m3di[ss, ss] + bias[db.offsets[k]:db.offsets[k + 1]]
                + aasc[aa, aa])
        rec = eng._identity_record(k)
        assert rec.raw_score == int(np.int16(diag.sum()))
        assert rec.backtrace == "M" * len(ss) and rec.seq_id == 1.0
    _rec, surv = traced_search
    eng._traceback_batch(*surv)
    held = [v for v in vars(eng).values() if isinstance(v, np.ndarray)]
    held += [x for v in vars(eng).values() if isinstance(v, dict)
             for x in v.values() if isinstance(x, np.ndarray)]
    assert held and all(COMBINED_ALPHA not in a.shape for a in held)
    assert not hasattr(port_structure, "PROFILE_CACHE")


def test_struct_engine_refuses_alt_alignments(subsets):
    """--alt-ali serves the sequence search only: a structure engine
    refuses it rather than run the sequence traceback."""
    db, _ = subsets
    eng = _engine(db, alt_alignments=1)
    with pytest.raises(NotImplementedError, match="--alt-ali"):
        eng._compute_alt_alignments({0: [eng._identity_record(1)]})


# ------------------------------------------------------- the traceback
@pytest.fixture(scope="module")
def traced_search(subsets):
    """structure_search of the subset under trace.start(): (what was
    recorded, every pair its traceback traced as a (7, n) array of qk, tk,
    q_start, q_end, t_start, t_end, score)."""
    db, _ = subsets
    seen = []
    batch = StructureAlignmentEngine._traceback_batch

    def keeping(self, *pairs):
        seen.append([np.array(a, dtype=np.int64) for a in pairs])
        return batch(self, *pairs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StructureAlignmentEngine, "_traceback_batch", keeping)
        trace.start()
        try:
            structure_search(db, db, device="cpu")
        finally:
            rec = trace.stop()
    surv = np.stack([np.concatenate([s[i] for s in seen]) for i in range(7)])
    return rec, surv


def test_struct_traceback_is_one_batch(traced_search):
    """The structure search traces on the batched route: every
    `align.traceback` span is named "struct", and no pair is counted on
    the per-pair route."""
    rec, surv = traced_search
    spans = [s for s in rec.spans if s[0] == "align.traceback"]
    assert spans and all(s[4]["route"] == "struct" for s in spans)
    counts: dict = {}
    for name, _tid, _t, n in rec.counts:
        counts[name] = counts.get(name, 0) + n
    assert counts.get("traceback_pair_calls", 0) == 0
    assert counts["traceback_pairs"] == surv.shape[1] > 0


def _db_arrays(db, bias):
    """(qss, qaa, bias, qoffs, tss, taa, toffs) of a self search of db;
    the offsets hold each key's first residue and the end."""
    return (db.ss_data, db.seq_data, bias, db.offsets, db.ss_data,
            db.seq_data, db.offsets)


def _pack(genes):
    """Concatenated (3Di, aa[, bias]) arrays of a list of genes, and their
    offsets."""
    offs = np.concatenate(([0], np.cumsum([len(g[0]) for g in genes])))
    return ([np.concatenate([g[c] for g in genes])
             for c in range(len(genes[0]))], offs)


def _cells(arrays, qk, tk, rect=None):
    """int32 sums and int8 cells of the combined alphabet over a pair's
    rectangle (q_start, q_end, t_start, t_end), whole genes by default."""
    qss, qaa, bias, qoffs, tss, taa, toffs = arrays
    m3di, aasc, _ = combined_matrices()
    qs = slice(qoffs[qk], qoffs[qk + 1])
    ts = slice(toffs[tk], toffs[tk + 1])
    if rect is not None:
        qs = slice(qoffs[qk] + rect[0], qoffs[qk] + rect[1] + 1)
        ts = slice(toffs[tk] + rect[2], toffs[tk] + rect[3] + 1)
    q3, qa = qss[qs].astype(np.int64), qaa[qs].astype(np.int64)
    t3, ta = tss[ts].astype(np.int64), taa[ts].astype(np.int64)
    s = (m3di[q3[:, None], t3[None, :]] + bias[qs].astype(np.int64)[:, None]
         + aasc[qa[:, None], ta[None, :]])
    return s, s.astype(np.int8)


def _local_scores(cells):
    """H of the affine-gap local DP over a cell matrix at full width: the
    banded traceback's recurrence with every cell in its band."""
    n, m = cells.shape
    low = -(1 << 40)
    out = np.zeros((n, m), np.int64)
    h = np.zeros(m + 1, np.int64)
    e = np.full(m + 1, low, np.int64)
    col = np.arange(m, dtype=np.int64)
    for i in range(n):
        e[1:] = np.maximum(h[1:] - GO, e[1:] - GE)
        pre = np.maximum(np.maximum(h[:-1] + cells[i], e[1:]), 0)
        # F[j] = max over k < j of pre[k] - GO - (j - 1 - k) * GE
        opened = np.maximum.accumulate(pre + col * GE)
        f = np.full(m, low, np.int64)
        f[1:] = opened[:-1] - GO - (col[1:] - 1) * GE
        h[1:] = out[i] = np.maximum(pre, f)
    return out


def _whole_pairs(arrays, keys):
    """(7, n) pairs over whole genes (qk, tk), each scored by its corner,
    which must be the rectangle's best cell: the walk from it then runs
    back to the first residues."""
    qoffs, toffs = arrays[3], arrays[6]
    rows = []
    for qk, tk in keys:
        h = _local_scores(_cells(arrays, qk, tk)[1])
        assert h[-1, -1] == h.max() > 0, (qk, tk)
        rows.append((qk, tk, 0, qoffs[qk + 1] - qoffs[qk] - 1, 0,
                     toffs[tk + 1] - toffs[tk] - 1, h[-1, -1]))
    return np.array(rows, dtype=np.int64).T


def _mutated(rng, gene, lo, hi, sub=0.15, insert=0, delete=0, keep=12):
    """A copy of (3Di, aa) residues [lo, hi) of a gene with substitutions,
    an insertion of `insert` random residues and a deletion of `delete`
    residues in its middle; its first and last `keep` residues are kept."""
    ss, aa = (np.array(g[lo:hi], dtype=np.uint8) for g in gene[:2])
    n = hi - lo
    hit = rng.random(n) < sub
    hit[:keep] = hit[-keep:] = False
    ss[hit] = rng.integers(0, 20, int(hit.sum()))
    hit = rng.random(n) < sub
    hit[:keep] = hit[-keep:] = False
    aa[hit] = rng.integers(0, 20, int(hit.sum()))
    a, b = n // 3, 2 * n // 3
    ins = rng.integers(0, 20, (2, insert)).astype(np.uint8)
    ss = np.concatenate([ss[:a], ins[0], ss[a:b], ss[b + delete:]])
    aa = np.concatenate([aa[:a], ins[1], aa[a:b], aa[b + delete:]])
    return ss, aa


def _gene(db, bias, k):
    o = slice(db.offsets[k], db.offsets[k + 1])
    return db.ss_data[o], db.seq_data[o], bias[o]


def _case_offset(db, bias, surv, rng):
    """The subset's pairs whose rectangles start inside both genes."""
    keep = (surv[2] > 0) & (surv[4] > 0)
    assert keep.sum() >= 5
    return [(_db_arrays(db, bias), surv[:, keep])]


def _case_single(db, bias, surv, rng):
    """1 x 1 rectangles on cells of the subset's genes that score above
    0, scored by that cell."""
    arrays = _db_arrays(db, bias)
    rows = []
    while len(rows) < 24:
        qk, tk = rng.integers(0, db.size, 2)
        i = rng.integers(0, db.lengths[qk])
        j = rng.integers(0, db.lengths[tk])
        cell = int(_cells(arrays, qk, tk, (i, i, j, j))[1][0, 0])
        if cell > 0:
            rows.append((qk, tk, i, i, j, j, cell))
    return [(arrays, np.array(rows, dtype=np.int64).T)]


def _case_doubling(db, bias, surv, rng):
    """Equal spans (a band of 1) whose best path leaves the diagonal by 4
    to 12: the target holds an insertion in its first half and a
    deletion as long in its second, so the band has to double."""
    genes, targets = [], []
    for k in np.argsort(-db.lengths)[:6]:
        n = min(int(db.lengths[k]), 240)
        g = _gene(db, bias, k)
        d = int(rng.integers(4, 13))
        genes.append(tuple(x[:n] for x in g))
        targets.append(_mutated(rng, g, 0, n, sub=0.1, insert=d, delete=d))
    (qss, qaa, qb), qoffs = _pack(genes)
    (tss, taa), toffs = _pack(targets)
    arrays = (qss, qaa, qb, qoffs, tss, taa, toffs)
    return [(arrays, _whole_pairs(arrays, [(p, p) for p in range(6)]))]


def _case_longest(db, bias, surv, rng):
    """The subset's longest traced pair, and its longest gene against a
    copy with substitutions and unequal indels."""
    span = (surv[3] - surv[2]) + (surv[5] - surv[4])
    top = surv[:, [int(np.argmax(span))]]
    k = int(np.argmax(db.lengths))
    g = _gene(db, bias, k)
    (qss, qaa, qb), qoffs = _pack([g])
    (tss, taa), toffs = _pack([_mutated(rng, g, 0, len(g[0]), insert=3,
                                        delete=9)])
    arrays = (qss, qaa, qb, qoffs, tss, taa, toffs)
    return [(_db_arrays(db, bias), top),
            (arrays, _whole_pairs(arrays, [(0, 0)]))]


def _case_alphabet_ends(db, bias, surv, rng):
    """Genes with the last symbol of both alphabets (20) on both sides
    and 3Di bias at -128 and 127, so the int32 sums leave int8 both ways
    and the cells wrap."""
    genes, targets = [], []
    for k in np.argsort(-db.lengths)[6:10]:
        n = min(int(db.lengths[k]), 200)
        ss, aa, b = (np.array(x[:n]) for x in _gene(db, bias, k))
        ss[30::7] = 20
        aa[33::5] = 20
        b[40:n - 20:9] = np.where(np.arange(len(b[40:n - 20:9])) % 2,
                                  127, -128)
        t = _mutated(rng, (ss, aa), 0, n, sub=0.1, insert=2, delete=2)
        t[0][50::11] = 20
        t[1][52::13] = 20
        genes.append((ss, aa, b))
        targets.append(t)
    (qss, qaa, qb), qoffs = _pack(genes)
    (tss, taa), toffs = _pack(targets)
    arrays = (qss, qaa, qb, qoffs, tss, taa, toffs)
    sums = np.concatenate([_cells(arrays, p, p)[0].ravel()
                           for p in range(4)])
    assert sums.max() > 127 and sums.min() < -128
    return [(arrays, _whole_pairs(arrays, [(p, p) for p in range(4)]))]


CASES = {"offset": _case_offset, "single": _case_single,
         "doubling": _case_doubling, "longest": _case_longest,
         "alphabet_ends": _case_alphabet_ends}


def _struct_batch_call(arrays, pairs):
    qss, qaa, bias, qoffs, tss, taa, toffs = arrays
    m3di, aasc, _ = combined_matrices()
    return banded_align_struct_batch(
        qss, qaa, qoffs[:-1], bias, tss, taa, toffs[:-1], m3di, aasc,
        *pairs, GO, GE)


def _per_pair(arrays, pairs):
    """One banded_align_profile_u16 call a pair over the int8 (441, L)
    combined profile of its query (profile[ss*21 + aa, i] = m3di[q_ss_i,
    ss] + bias_i + aa_scaled[q_aa_i, aa], the int32 sum narrowed), and
    its identities: M columns with equal amino acids."""
    qss, qaa, bias, qoffs, tss, taa, toffs = arrays
    m3di, aasc, _ = combined_matrices()
    ops_list, idents = [], []
    for qk, tk, qs, qe, ts, te, score in pairs.T.tolist():
        q = slice(qoffs[qk], qoffs[qk + 1])
        t = slice(toffs[tk], toffs[tk + 1])
        p3 = (m3di[qss[q].astype(np.int64)]
              + bias[q].astype(np.int32)[:, None])
        prof = (p3[:, :, None] + aasc[qaa[q].astype(np.int64)][:, None, :]
                ).reshape(len(p3), COMBINED_ALPHA)
        tsym = tss[t].astype(np.int32) * 21 + taa[t].astype(np.int32)
        ops = banded_align_profile_u16(
            tsym[ts:te + 1], qe - qs + 1,
            np.ascontiguousarray(prof.T, dtype=np.int8), qs, score, GO, GE)
        b = np.frombuffer(ops.encode(), dtype=np.uint8)
        is_m = b == ord("M")
        q_adv = is_m | (b == ord("I"))
        t_adv = is_m | (b == ord("D"))
        qp = qs + np.cumsum(q_adv) - q_adv
        tp = ts + np.cumsum(t_adv) - t_adv
        ops_list.append(ops)
        idents.append(int((qaa[q][qp[is_m]] == taa[t][tp[is_m]]).sum()))
    return ops_list, idents


@pytest.mark.parametrize("case", list(CASES))
def test_struct_batch_matches_per_pair(subsets, traced_search, case):
    """banded_align_struct_batch against banded_align_profile_u16 a pair:
    the same ops and identity counts; every walk consumes its rectangle."""
    db, _ = subsets
    bias = _engine(db)._ss_bias_all()
    rng = np.random.default_rng(1000 + sorted(CASES).index(case))
    for arrays, pairs in CASES[case](db, bias, traced_search[1], rng):
        ops, idents = _struct_batch_call(arrays, pairs)
        want_ops, want_idents = _per_pair(arrays, pairs)
        assert ops == want_ops
        assert idents.tolist() == want_idents
        for o, (_q, _t, qs, qe, ts, te, _s) in zip(ops, pairs.T.tolist()):
            assert o[0] == "M" and o[-1] == "M"
            assert o.count("M") + o.count("I") == qe - qs + 1
            assert o.count("M") + o.count("D") == te - ts + 1
            if case == "doubling":
                step = np.array([{"M": 0, "I": 1, "D": -1}[c] for c in o])
                # the path leaves the band of 1 the spans start with
                assert np.abs(np.cumsum(step)).max() > 1


def test_struct_batch_threads_and_failures(subsets, traced_search):
    """One thread and every thread trace the same; an unreachable score
    fails the batch; an empty batch is empty."""
    db, _ = subsets
    arrays = _db_arrays(db, _engine(db)._ss_bias_all())
    pairs = np.tile(traced_search[1], 10)
    try:
        set_num_threads(1)
        one = _struct_batch_call(arrays, pairs)
        set_num_threads(os.cpu_count())
        every = _struct_batch_call(arrays, pairs)
    finally:
        set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "0")))
    assert one[0] == every[0] and one[1].tolist() == every[1].tolist()
    bad = pairs[:, :3].copy()
    bad[6, 1] += 10_000
    with pytest.raises(RuntimeError, match="1 failed"):
        _struct_batch_call(arrays, bad)
    ops, idents = _struct_batch_call(arrays, pairs[:, :0])
    assert ops == [] and len(idents) == 0
