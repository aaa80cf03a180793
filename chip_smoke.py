#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spacedust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- compiles the native host engines (g++) and csrc/sw.cu
                (nvcc, sm_90a) from the checkout into
                spacedust_tpu_torch/_build;
  3. kernels -- sw_forward / sw_reverse against their plain PyTorch version
                (ops/sw.py) on the same CUDA tensors, on a seeded ragged
                batch: lengths 1-3,000, zero-score pairs, planted ties,
                int8-wrapping bias, a 9,000 x 9,000 and a 40,000 x 600
                pair.  All six outputs must be equal (tolerance 0: the DP
                is integer);
  4. small   -- createsetdb + clustersearch --filter-self-match through the
                CLI on the small synthetic genome set; the result must equal
                tests/fixtures/torch_port_small.tsv (recorded by the JAX
                package) block for block;
  5. real    -- the same through createsetdb / cluster_search_to_file on
                the real-size synthetic set (4,300 + 1,600 genes), with the
                kernel launch counters reset just before and read just
                after; hit and cluster counts and the canonical-TSV sha256
                must equal tests/fixtures/torch_port_real.json;
  6. kernels-struct -- sw_forward_struct / sw_reverse_struct against
                their plain version (ops/sw.py::sw_struct_jobs_ref) on a
                seeded ragged batch: lengths 1-2,700, homologs (kept 3Di,
                remote amino acids), planted ties, zero-score pairs, 3Di
                bias at -128..127 (the 3Di channel wraps int8), a 9,000 x
                9,000 and a 40,000 x 600 pair; all six outputs equal;
  7. struct-small -- through the CLI on the small structure set:
                createsetdb of the Foldseek-style flat DB, clustersearch
                --search-mode 2, then aa2foldseek and --search-mode 1 (which
                must launch all four kernels); both results must equal
                tests/fixtures/torch_port_struct_small{,_mode1}.tsv;
  8. struct-real -- --search-mode 2 through cluster_search_to_file on the
                real-size structure set (4,300 + 1,600 genes), counters reset
                just before and read just after (both struct kernels must
                launch); every gene of >= 100 aa must find itself with
                E < 1e-10, and the set of the size that
                tests/fixtures/torch_port_struct_real.json names must give
                its hit / cluster counts and sha256;
  9. timing  -- each kernel against its plain version on the largest stage
                the real runs dispatched, with the main path's own resident
                tensors: equal outputs, milliseconds and GCUPS.

The line before the last is the card's name and power limit, the one
before it a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GO, GE = 11, 1
SEED = 0
TOL = 0                 # integer DP: kernel and plain version agree exactly
STRUCT_GO = 10          # foldseek's gap costs in structure mode
STRUCT_REPLACES = "spacedust_tpu/ops/sw_engine.py:608"
# direction -> (wrapper, replaced TPU kernel / device program, launch
# counter)
KERNELS = {
    "fwd": ("sw_forward", "spacedust_tpu/ops/sw_pallas.py:41",
            "FORWARD_LAUNCHES"),
    "rev": ("sw_reverse", "spacedust_tpu/ops/sw_pallas.py:147",
            "REVERSE_LAUNCHES"),
    "fwd_struct": ("sw_forward_struct", STRUCT_REPLACES,
                   "FORWARD_STRUCT_LAUNCHES"),
    "rev_struct": ("sw_reverse_struct", STRUCT_REPLACES,
                   "REVERSE_STRUCT_LAUNCHES")}
GATHER = "spacedust_tpu/ops/sw_engine.py:82"     # fused into the kernels


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def cells(jobs: np.ndarray) -> int:
    return int((jobs[1] * jobs[3]).sum())


def counts(tsv: str) -> tuple[int, int]:
    lines = tsv.splitlines()
    return (sum(1 for ln in lines if ln.startswith(">")),
            sum(1 for ln in lines if ln.startswith("#")))


# ------------------------------------------------------------- 3. kernels
def _mutate(rng, seq: np.ndarray, pct_sub: int) -> np.ndarray:
    out = seq.copy()
    hit = rng.integers(0, 100, len(out)) < pct_sub
    out[hit] = rng.integers(0, 20, int(hit.sum()))
    for _ in range(len(out) // 200):
        p = int(rng.integers(1, max(len(out), 2)))
        k = int(rng.integers(1, 6))
        if rng.integers(0, 2):
            out = np.concatenate([out[:p], rng.integers(0, 20, k), out[p:]])
        elif len(out) > k + 1:
            out = np.concatenate([out[:p], out[p + k:]])
    return out.astype(np.uint8)


def kernel_batch(seed: int = SEED):
    """Resident query / bias / target arrays and a (5, n) forward job
    array: 2,000 ragged pairs of 1-3,000 residues (homologs, planted ties,
    zero-score, length-1 and int8-wrapping pairs), then a 9,000 x 9,000
    homolog pair and a 40,000 x 600 pair, whose query is longer than the
    JAX engine's top rung (32,768)."""
    rng = np.random.default_rng(seed)
    n = 2000
    ql = np.minimum(np.exp(rng.uniform(0, np.log(3000), n)), 3000)
    tl = np.minimum(np.exp(rng.uniform(0, np.log(3000), n)), 3000)
    ql, tl = ql.astype(np.int64), tl.astype(np.int64)
    ql[:8] = 1
    tl[8:16] = 1
    ql[16:20] = tl[16:20] = 1
    qs, bs, ts = [], [], []
    for p in range(n):
        q = rng.integers(0, 21, ql[p]).astype(np.uint8)
        b = rng.integers(-3, 4, ql[p]).astype(np.int8)
        kind = p % 8
        if kind in (0, 1, 2) and ql[p] > 20:          # homolog
            lo = int(rng.integers(0, ql[p] // 2))
            t = _mutate(rng, q[lo:lo + int(tl[p])], int(rng.integers(5, 60)))
        elif kind == 3 and ql[p] > 24:                # tie: motif twice
            m = q[:min(int(ql[p]) // 2, 40)]
            gap = rng.integers(0, 20, int(rng.integers(0, 30)))
            t = np.concatenate([m, gap.astype(np.uint8), m])
        else:
            t = rng.integers(0, 21, tl[p]).astype(np.uint8)
        if kind == 4:
            b[:] = -40                                # every cell < 0
        elif kind == 5:
            b = rng.integers(-128, 128, ql[p]).astype(np.int8)   # wraps
        qs.append(q)
        bs.append(b)
        ts.append(t)
    q9 = rng.integers(0, 20, 9000).astype(np.uint8)
    q40 = rng.integers(0, 20, 40000).astype(np.uint8)
    qs += [q9, q40]
    bs += [rng.integers(-3, 4, 9000).astype(np.int8),
           rng.integers(-3, 4, 40000).astype(np.int8)]
    ts += [_mutate(rng, q9, 30)[:9000], _mutate(rng, q40[20000:20600], 20)]
    qlen = np.array([len(q) for q in qs], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    qoff = np.concatenate(([0], np.cumsum(qlen)[:-1]))
    toff = np.concatenate(([0], np.cumsum(tlen)[:-1]))
    jobs = np.stack([qoff, qlen, toff, tlen, np.full(len(qs), -1)])
    return (np.concatenate(qs), np.concatenate(bs), np.concatenate(ts),
            np.ascontiguousarray(jobs, dtype=np.int64))


def kernel_batch_struct(seed: int = SEED):
    """Resident 3Di / amino-acid / 3Di-bias arrays of both sides and a
    (5, n) forward job array: 2,000 ragged pairs of 1-2,700 residues
    (homologs with kept 3Di and remote amino acids, planted ties,
    zero-score, length-1 and int8-wrapping 3Di-bias pairs), then a 9,000 x
    9,000 homolog pair and a 40,000 x 600 pair."""
    rng = np.random.default_rng(seed + 1)
    n = 2000
    ql = np.minimum(np.exp(rng.uniform(0, np.log(2700), n)), 2700)
    tl = np.minimum(np.exp(rng.uniform(0, np.log(2700), n)), 2700)
    ql, tl = ql.astype(np.int64), tl.astype(np.int64)
    ql[:8] = 1
    tl[8:16] = 1
    ql[16:20] = tl[16:20] = 1
    qs, qa, bs, ts, ta = [], [], [], [], []
    for p in range(n):
        s = rng.integers(0, 21, ql[p]).astype(np.uint8)
        a = rng.integers(0, 21, ql[p]).astype(np.uint8)
        b = rng.integers(-3, 4, ql[p]).astype(np.int8)
        kind = p % 8
        if kind in (0, 1, 2) and ql[p] > 20:          # homolog
            lo = int(rng.integers(0, ql[p] // 2))
            t_s = _mutate(rng, s[lo:lo + int(tl[p])], int(rng.integers(15, 40)))
            t_a = rng.integers(0, 20, len(t_s)).astype(np.uint8)
            m = min(len(t_a), len(a) - lo)
            keep = rng.integers(0, 100, m) < 40
            t_a[:m][keep] = a[lo:lo + m][keep]
        elif kind == 3 and ql[p] > 24:                # tie: motif twice
            k = min(int(ql[p]) // 2, 40)
            gap = rng.integers(0, 20, int(rng.integers(0, 30))).astype(np.uint8)
            t_s = np.concatenate([s[:k], gap, s[:k]])
            t_a = np.concatenate([a[:k], gap, a[:k]])
        else:
            t_s = rng.integers(0, 21, tl[p]).astype(np.uint8)
            t_a = rng.integers(0, 21, tl[p]).astype(np.uint8)
        if kind == 4:
            b[:] = -100                               # every cell < 0
        elif kind == 5:
            b = rng.integers(-128, 128, ql[p]).astype(np.int8)   # wraps
        qs.append(s)
        qa.append(a)
        bs.append(b)
        ts.append(t_s)
        ta.append(t_a)
    for qlen, tlen in ((9000, 9000), (40000, 600)):
        s = rng.integers(0, 20, qlen).astype(np.uint8)
        a = rng.integers(0, 20, qlen).astype(np.uint8)
        lo = (qlen - tlen) // 2
        qs.append(s)
        qa.append(a)
        bs.append(rng.integers(-3, 4, qlen).astype(np.int8))
        ts.append(_mutate(rng, s[lo:lo + tlen], 25)[:tlen])
        t_a = a[lo:lo + len(ts[-1])].copy()
        hit = rng.integers(0, 100, len(t_a)) < 60
        t_a[hit] = rng.integers(0, 20, int(hit.sum()))
        ta.append(t_a)
    qlen = np.array([len(q) for q in qs], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    qoff = np.concatenate(([0], np.cumsum(qlen)[:-1]))
    toff = np.concatenate(([0], np.cumsum(tlen)[:-1]))
    jobs = np.stack([qoff, qlen, toff, tlen, np.full(len(qs), -1)])
    return ([np.concatenate(x) for x in (qs, qa, bs, ts, ta)],
            np.ascontiguousarray(jobs, dtype=np.int64))


def reverse_jobs(jobs: np.ndarray, fwd: np.ndarray) -> np.ndarray:
    """Reverse-pass jobs for the pairs with a positive forward score:
    prefixes [0..q_end] x [0..t_end], terminate = the forward score."""
    keep = np.nonzero(fwd[0] > 0)[0]
    return np.ascontiguousarray(np.stack([
        jobs[0, keep], fwd[2, keep] + 1, jobs[2, keep], fwd[1, keep] + 1,
        fwd[0, keep]]), dtype=np.int64)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor) -> int:
    """Exact equality of the (6, n) outputs; returns max |diff|."""
    err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
    if err > TOL or not torch.equal(got, ref):
        bad = torch.nonzero((got != ref).any(dim=0)).flatten()[:5].tolist()
        fail(f"{name}: kernel != plain (max abs err {err}, pairs {bad})")
    return err


def plain(d: str):
    """The plain version of direction d's kernel, with the wrapper's
    arguments."""
    from spacedust_tpu_torch.ops.sw import sw_jobs_ref, sw_struct_jobs_ref
    ref = sw_struct_jobs_ref if d.endswith("struct") else sw_jobs_ref
    return lambda *args: ref(*args, reverse=d.startswith("rev"))


def check_batch(tag: str, resident: list, jobs: np.ndarray, go: int,
                dirs: tuple, errs: dict) -> None:
    """Each kernel of dirs (forward, then reverse on the forward's
    positive pairs) against its plain version on one seeded batch."""
    from spacedust_tpu_torch.ops import sw_cuda
    fwd = None
    for d in dirs:
        js = jobs if fwd is None else reverse_jobs(jobs, fwd)
        fn = getattr(sw_cuda, KERNELS[d][0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*resident, js, go, GE)
        torch.cuda.synchronize()
        k_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = plain(d)(*resident, js, go, GE)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        errs[d] = max(errs[d], compare(f"{tag} {d}", got, ref))
        out = got.cpu().numpy()
        if fwd is None:
            fwd = out
            n_zero = int((out[0] == 0).sum())
            if n_zero < 100 or out[0, -2] < 1000 or out[0, -1] < 300:
                fail(f"{tag} lost its shape: {n_zero} zero-score "
                     f"pairs, long-pair scores {out[0, -2]}, {out[0, -1]}")
        elif not out[3].all():
            fail(f"{tag}: the reverse pass missed a terminate score")
        print(f"[{tag}] {d}: {js.shape[1]} pairs, {cells(js) / 1e6:.1f} "
              f"M cells, all six outputs equal; one call (host clock): "
              f"kernel {k_ms:.1f} ms, plain {p_ms:.1f} ms")


def check_kernels(sub: torch.Tensor, errs: dict) -> None:
    q, b, t, jobs = kernel_batch()
    Q, B, T = (torch.from_numpy(a).to(sub.device) for a in (q, b, t))
    check_batch("kernels", [Q, B, T, sub], jobs, GO, ("fwd", "rev"), errs)


def check_kernels_struct(dev: torch.device, errs: dict) -> None:
    from spacedust_tpu_torch.search.structure import combined_matrices
    arrays, jobs = kernel_batch_struct()
    m3di, aasc, _ = combined_matrices()
    resident = [torch.from_numpy(a).to(dev) for a in arrays] + [
        torch.from_numpy(m.astype(np.int8)).to(dev) for m in (m3di, aasc)]
    check_batch("kernels-struct", resident, jobs, STRUCT_GO,
                ("fwd_struct", "rev_struct"), errs)


# ------------------------------------------------------- 4-6. the slices
def small_slice(work: Path) -> None:
    from spacedust_tpu_torch import cli, synth
    from spacedust_tpu_torch.cluster.summarize import canonical_blocks
    fa = synth.write_genome_set(work / "small", "small")
    db, out = str(work / "small_db"), str(work / "small.tsv")
    t0 = time.perf_counter()
    if cli.main(["createsetdb", *map(str, fa), db]) != 0:
        fail("createsetdb (small) failed")
    if cli.main(["clustersearch", db, db, out, str(work / "small_tmp"),
                 "--filter-self-match", "--device", "cuda"]) != 0:
        fail("clustersearch (small) failed")
    tsv = Path(out).read_text()
    want = (ROOT / "tests" / "fixtures" / "torch_port_small.tsv").read_text()
    if canonical_blocks(tsv) != canonical_blocks(want):
        fail("small slice differs from tests/fixtures/torch_port_small.tsv")
    print(f"[small] {counts(tsv)[0]} hits / {counts(tsv)[1]} clusters, "
          f"equal to the JAX fixture ({time.perf_counter() - t0:.1f} s)")


def read_counts() -> dict:
    from spacedust_tpu_torch.ops import sw_cuda
    return {d: getattr(sw_cuda, k[2]) for d, k in KERNELS.items()}


@contextlib.contextmanager
def recording(stages: dict, dirs: tuple):
    """Record, per direction, the arguments of the largest stage on its
    way to the wrapper (the wrappers are looked up at dispatch)."""
    from spacedust_tpu_torch.ops import sw_cuda
    saved = {d: getattr(sw_cuda, KERNELS[d][0]) for d in dirs}

    def recorded(d, fn):
        def call(*args):
            if (d not in stages
                    or args[-3].shape[1] > stages[d][-3].shape[1]):
                stages[d] = args
            return fn(*args)
        return call

    for d, fn in saved.items():
        setattr(sw_cuda, KERNELS[d][0], recorded(d, fn))
    try:
        yield
    finally:
        for d, fn in saved.items():
            setattr(sw_cuda, KERNELS[d][0], fn)


def real_slice(work: Path, dev: torch.device) -> tuple[dict, dict]:
    """The main path at real size.  Returns the launch counts of the run
    and, per direction, the largest stage it dispatched (the wrapper's
    arguments: resident tensors, sub and the job array)."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.workflow.clustersearch import (
        ClusterSearchParams, cluster_search_to_file)
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    fx = json.loads((ROOT / "tests" / "fixtures"
                     / "torch_port_real.json").read_text())
    size = next((k for k, v in synth.SIZES.items()
                 if list(v) == fx["sizes"]), None)
    if size is None or fx["seed"] != synth.SEED:
        fail("tests/fixtures/torch_port_real.json does not match synth.py")
    fa = synth.write_genome_set(work / size, size)
    t0 = time.perf_counter()
    db = create_setdb([str(p) for p in fa], str(work / f"{size}_db"))
    t_ingest = time.perf_counter() - t0

    stages: dict = {}
    with recording(stages, ("fwd", "rev")):
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        res = cluster_search_to_file(
            db, db, str(work / f"{size}.tsv"),
            params=ClusterSearchParams(filter_self_match=True), device=dev)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = read_counts()
    if launches["fwd"] <= 0 or launches["rev"] <= 0:
        fail(f"the main path did not launch both kernels: {launches}")
    hits, clusters = counts(res.tsv)
    sha = canonical_sha256(res.tsv)
    tm = res.timings
    print(f"[{size}] {db.size} genes, {len(db.seq_data)} residues; "
          f"createsetdb {t_ingest:.2f} s; clustersearch {t_search:.2f} s = "
          f"index {tm['index']:.2f} + prefilter wait {tm['prefilter']:.2f} "
          f"+ align {tm['align']:.2f} + aggregate {tm['aggregate']:.2f}")
    print(f"[{size}] align detail {json.dumps(tm['align_detail'])}")
    print(f"[{size}] launches {launches}; {hits} hits / {clusters} "
          f"clusters, canonical sha256 {sha}")
    want = (fx["hits"], fx["clusters"], fx["canonical_sha256"])
    if (hits, clusters, sha) != want:
        fail(f"{size} slice differs from the JAX fixture: "
             f"{(hits, clusters, sha)} vs {want}")
    return launches, stages


def struct_small(work: Path) -> None:
    """Modes 2 and 1 through the CLI on the small structure set."""
    from spacedust_tpu_torch import cli, synth
    from spacedust_tpu_torch.cluster.summarize import canonical_blocks
    base, ref = synth.write_struct_set(work / "struct_small", "small")
    db = str(work / "struct_small_db")
    if cli.main(["createsetdb", str(base), db]) != 0:
        fail("createsetdb of the flat DB (struct-small) failed")
    for mode in (2, 1):
        t0 = time.perf_counter()
        if mode == 1 and cli.main(["aa2foldseek", db, str(ref),
                                   "--device", "cuda"]) != 0:
            fail("aa2foldseek (struct-small) failed")
        out = str(work / f"struct_small_mode{mode}.tsv")
        before = read_counts()
        if cli.main(["clustersearch", db, db, out,
                     str(work / f"struct_small_tmp{mode}"),
                     "--filter-self-match", "--search-mode", str(mode),
                     "--device", "cuda"]) != 0:
            fail(f"clustersearch --search-mode {mode} (struct-small) failed")
        launched = {d: n - before[d] for d, n in read_counts().items()}
        need = KERNELS if mode == 1 else ("fwd_struct", "rev_struct")
        if any(launched[d] <= 0 for d in need):
            fail(f"--search-mode {mode} did not launch {list(need)}: "
                 f"{launched}")
        tsv = Path(out).read_text()
        name = ("torch_port_struct_small.tsv" if mode == 2
                else "torch_port_struct_small_mode1.tsv")
        want = (ROOT / "tests" / "fixtures" / name).read_text()
        if canonical_blocks(tsv) != canonical_blocks(want):
            fail(f"struct-small mode {mode} differs from {name}")
        print(f"[struct-small] mode {mode}: {counts(tsv)[0]} hits / "
              f"{counts(tsv)[1]} clusters, equal to the JAX fixture; "
              f"launches {launched} ({time.perf_counter() - t0:.1f} s)")


def self_hits_ok(db, tmp: Path) -> int:
    """Every gene of >= 100 aa finds itself with E < 1e-10 in the result
    checkpoint (the per-query alignment records); returns the count."""
    from spacedust_tpu_torch.db.mmseqs_io import FlatDB
    res = FlatDB.open(next(tmp.glob("*/result.index")).with_suffix(""))
    keys = set(res.keys())
    missing = []
    for k in np.nonzero(db.lengths >= 100)[0].tolist():
        lines = res.lines(k) if k in keys else []
        if not any(int(c[0]) == k and float(c[3]) < 1e-10
                   for c in (ln.split("\t") for ln in lines)):
            missing.append(k)
    if missing:
        fail(f"{len(missing)} genes of >= 100 aa lack a self hit with "
             f"E < 1e-10 (first: {missing[:5]})")
    return int((db.lengths >= 100).sum())


def struct_run(work: Path, dev: torch.device, size: str,
               stages: dict) -> tuple[dict, str]:
    """--search-mode 2 of the structure set at `size` through
    cluster_search_to_file; returns the launch counts and the TSV."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.workflow.clustersearch import (
        ClusterSearchParams, cluster_search_to_file)
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    base, _ref = synth.write_struct_set(work / f"struct_{size}", size)
    t0 = time.perf_counter()
    db = create_setdb([str(base)])
    t_ingest = time.perf_counter() - t0
    tmp = work / f"struct_{size}_tmp"
    with recording(stages, ("fwd_struct", "rev_struct")):
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        res = cluster_search_to_file(
            db, db, str(work / f"struct_{size}.tsv"), str(tmp),
            params=ClusterSearchParams(filter_self_match=True,
                                       search_mode=2), device=dev)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = read_counts()
    if launches["fwd_struct"] <= 0 or launches["rev_struct"] <= 0:
        fail(f"--search-mode 2 did not launch both struct kernels: "
             f"{launches}")
    n_self = self_hits_ok(db, tmp)
    tm = res.timings
    hits, clusters = counts(res.tsv)
    print(f"[struct-{size}] {db.size} genes, {len(db.seq_data)} residues; "
          f"createsetdb {t_ingest:.2f} s; clustersearch {t_search:.2f} s = "
          f"structure_search {tm['structure_search']:.2f} + aggregate "
          f"{tm['aggregate']:.2f}")
    print(f"[struct-{size}] align detail {json.dumps(tm['align_detail'])}")
    print(f"[struct-{size}] launches {launches}; {hits} hits / {clusters} "
          f"clusters, canonical sha256 {canonical_sha256(res.tsv)}; "
          f"{n_self} genes of >= 100 aa find themselves with E < 1e-10")
    return launches, res.tsv


def struct_real(work: Path, dev: torch.device) -> tuple[dict, dict]:
    """The real-size structure run (launch counts of its run), and the
    run of the fixture's size held against the fixture."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    fx = json.loads((ROOT / "tests" / "fixtures"
                     / "torch_port_struct_real.json").read_text())
    size = next((k for k, v in synth.SIZES.items()
                 if list(v) == fx["sizes"]), None)
    if size is None or fx["seed"] != synth.SEED:
        fail("tests/fixtures/torch_port_struct_real.json does not match "
             "synth.py")
    stages: dict = {}
    launches, tsv = struct_run(work, dev, "real", stages)
    if size != "real":
        _, tsv = struct_run(work, dev, size, {})
    got = (*counts(tsv), canonical_sha256(tsv))
    want = (fx["hits"], fx["clusters"], fx["canonical_sha256"])
    if got != want:
        fail(f"struct-{size} differs from the JAX fixture: {got} vs {want}")
    print(f"[struct-{size}] equal to tests/fixtures/torch_port_struct_real"
          f".json")
    return launches, stages


def time_stages(stages: dict, launches: dict, errs: dict,
                card: str) -> list:
    """Kernel (CUDA events over 3 calls after a warm one) against the
    plain version (host clock, one call) on the main path's largest
    stages.  These launches come after the counts were read."""
    from spacedust_tpu_torch.ops import sw_cuda
    report = []
    for d, (name, replaces, _counter) in KERNELS.items():
        args = stages[d]
        js = args[-3]
        fn = getattr(sw_cuda, name)
        got = fn(*args)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        reps = 3
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        k_ms = e0.elapsed_time(e1) / reps
        t0 = time.perf_counter()
        ref = plain(d)(*args)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        errs[d] = max(errs[d], compare(f"main-path {d} stage", got, ref))
        c = cells(js)
        print(f"[timing] {name}, main path's largest {d} stage: "
              f"{js.shape[1]} pairs, {c / 1e9:.3f} G cells; kernel "
              f"{k_ms:.2f} ms = {c / k_ms / 1e6:.2f} GCUPS; plain "
              f"{p_ms:.2f} ms = {c / p_ms / 1e6:.3f} GCUPS; equal; {card}")
        entry = {
            "name": name, "route": "cuda",
            "source": "spacedust_tpu_torch/csrc/sw.cu",
            "replaces": replaces, "launches": launches[d],
            "max_abs_err": errs[d], "ms": k_ms, "plain_ms": p_ms,
            "pairs": int(js.shape[1]), "cells": c, "gcups": c / k_ms / 1e6,
            "plain_gcups": c / p_ms / 1e6}
        if not d.endswith("struct"):
            entry["also_replaces"] = GATHER
        report.append(entry)
    return report


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA "
             "card")
    if not (ROOT / "spacedust_tpu_torch" / "csrc" / "sw.cu").exists():
        fail(f"{ROOT} holds no checkout of the repository")
    sys.path.insert(0, str(ROOT))
    from spacedust_tpu_torch import native
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.stats.submat import load_substitution_matrix
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    # 2. build
    t0 = time.perf_counter()
    native.build()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw_cuda.build(verbose=True)
    print(f"[build] native (g++) {t_native:.2f} s, csrc/sw.cu (nvcc) "
          f"{time.perf_counter() - t0:.2f} s")

    sub = torch.from_numpy(
        load_substitution_matrix().sub_int.astype(np.int8)).to(dev)
    errs = dict.fromkeys(KERNELS, 0)
    check_kernels(sub, errs)
    check_kernels_struct(dev, errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        small_slice(Path(tmp))
        launches, stages = real_slice(Path(tmp), dev)
        struct_small(Path(tmp))
        s_launches, s_stages = struct_real(Path(tmp), dev)
    launches.update({d: s_launches[d] for d in ("fwd_struct", "rev_struct")})
    stages.update(s_stages)
    report = time_stages(stages, launches, errs, card)

    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
