#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spacedust_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases kernels,real,timing]

Phases, each fatal on failure (the script exits non-zero and prints no
result line).  Phases 1 and 2 always run; --phases picks among the rest
by name (a comma list, in any order; they run in the order below), for a
quick look at one of them.  Such a partial run exits 0 when its phases
pass and prints none of the last three lines: only a whole run prints
the kernels line, the card and the result.

  1. device  -- a CUDA card is required; prints its name and power limit;
  2. build   -- compiles the native host engines (g++) and csrc/sw.cu
                (nvcc, sm_90a) from the checkout into
                spacedust_tpu_torch/_build, the two side by side;
  3. kernels -- sw_forward / sw_reverse against their plain PyTorch version
                (ops/sw.py) on the same CUDA tensors, on a seeded ragged
                batch: lengths 1-3,000, zero-score pairs, planted ties,
                int8-wrapping bias, a 9,000 x 9,000 and a 40,000 x 600
                pair.  All six outputs must be equal (tolerance 0: the DP
                is integer).  Then, for each class R of query rows per
                lane that the kernels' body (a warp shares a pair) is
                compiled for, the boundary shapes and planted ties of
                edge_batch, with every pair forced into that class:
                forward, reverse on the same pairs (terminate = their
                score) and reverse on the derived prefixes, and the planted
                ties must come out where the design puts them.  Then both
                again with the iterative search's realignment matrix
                (blosum62_bf2_bias) and the composition bias it gives each
                query, the extreme-bias pairs kept: the seeded batch and
                every class on the edge batches, all six outputs equal;
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
                9,000 and a 40,000 x 600 pair; all six outputs equal.  Then
                every compiled class on edge_batch_struct, the two-channel
                form of edge_batch (ties planted on the summed score), as
                in phase 3;
  7. struct-small -- through the CLI on the small structure set:
                createsetdb of the Foldseek-style flat DB, clustersearch
                --search-mode 2, then aa2foldseek and --search-mode 1 (which
                must launch the sequence and the structure kernels); both
                results must equal
                tests/fixtures/torch_port_struct_small{,_mode1}.tsv;
  8. struct-real -- --search-mode 2 through cluster_search_to_file on the
                real-size structure set (4,300 + 1,600 genes), counters reset
                just before and read just after (both struct kernels must
                launch); every gene of >= 100 aa must find itself with
                E < 1e-10, and the set of the size that
                tests/fixtures/torch_port_struct_real.json names must give
                its hit / cluster counts and sha256;
  9. toolkit -- the alignment controls and the module toolkit.  The
                kernels over explicit targets: sw_forward / sw_reverse on a
                seeded batch whose targets are masked copies in an array of
                their own (X runs at the start, in the middle, up to the
                last column but one, and whole targets), all six outputs
                equal to the plain version.  Then, through the CLI on the
                small set and the repeat set (homologs with tandem copies
                of a segment): `search` with --alt-ali 2 --max-accept 3
                --max-rejected 2 and with --alt-ali 2 alone,
                `convertalignments`, and besthitbyset -> mergeresultsbyset
                -> combinehits -> clusterhits -> summarizeresults over a
                search with clustersearch's flags; every file must equal its
                JAX-recorded fixture (tests/fixtures/torch_port_SET_*) byte
                for byte and the chain's last file clustersearch's TSV.
                Last, `search --alt-ali 2` on the real-size set with the
                repeat set's genes beside it in one setDB (6,020 genes),
                counters reset just before and read just after: without its
                alternative records the result must be that of `search`
                alone, line for line; every alternative record passes the
                E-value gate and lies off the masked ranges of its parent
                and of the records before it in its chain; at least ten
                exist; and the masked rounds cost at most 2 launches a
                direction beyond the main pass;
 10. kernels-prof -- sw_forward_prof / sw_reverse_prof against their
                plain version (ops/sw.py::sw_prof_jobs_ref) on a seeded
                ragged batch: lengths 1-3,000, homologs (profiles drawn
                round the query's substitution rows), planted ties,
                zero-score pairs, profile values at -32 and 31, a 9,000 x
                9,000 and a 40,000 x 600 pair; all six outputs equal.  Then
                every compiled class on edge_batch_prof (edge_batch's pairs
                as profile rows, noise off the planted pairs), as in
                phase 3;
 11. profile-small -- through the CLI on the small set: createsetdb,
                clusterdb (and --single-step-clustering 0), each ClusterDB
                equal to the JAX-recorded directory
                tests/fixtures/torch_port_small_clu{,_cascade} (clusters,
                every array, the clu_aln lines), then clustersearch
                --filter-self-match --profile-cluster-search --cluster-db
                over the port's directory and over the JAX-written one: both
                TSVs equal tests/fixtures/torch_port_small_profile.tsv byte
                for byte, and the prof kernels and K1/K2 launch;
 12. profile-real -- clusterdb and the profile cluster search through
                cluster_db / cluster_search_to_file on the real-size set,
                counters reset just before and read just after (both prof
                kernels and K1/K2 must launch), held to invariants: every
                key in exactly one cluster, every representative's clu_aln
                holding its self alignment, every representative of >= 100
                aa finding its own profile with E < 1e-10;
 13. iterative-small -- `search --num-iterations 2` and `3` through the
                CLI on the small set and `--num-iterations 2` on the family
                set (synth.py --size families: chains of divergence, where
                the profile round adds records): each TSV equal to
                tests/fixtures/torch_port_{small,families}_iterN.tsv byte for
                byte; K1/K2 and both prof kernels must launch;
 14. iterative-real -- `search --num-iterations 2` through the CLI on the
                real-size set, counters reset just before and read just
                after (K1/K2 and both prof kernels must launch), held to
                invariants: every gene of >= 100 aa finds itself with
                E < 1e-10; no round-1 record's target is one that round 0
                found at E <= --e-profile; every record of round 0 carries
                the score and E-value the acceptance pass gave it.  Prints
                each round's stage seconds, index size and SW engines'
                metrics, and the resident set after each round's index;
 15. split   -- clustersearch --split-memory-limit through the CLI on the
                small set at 400,000 and 150,000 bytes (4 and 9 target
                splits) and with --profile-cluster-search over
                tests/fixtures/torch_port_small_clu at 64,000,000 bytes
                (3-4 profile slices), each equal to the unsplit fixture
                byte for byte; then the real-size set at 7,000,000 bytes (4
                target splits) through cluster_search_to_file, counters
                reset just before and read just after, equal to
                tests/fixtures/torch_port_real.json;
 16. sharded -- the real set over 4 target shards on the card (ROADMAP A8,
                B8): the concurrent split prefilter's hits equal to the
                single index's (as sets a query); the sharded clustersearch
                (parallel/pipeline.py::sharded_cluster_search), counters
                reset just before and read just after, equal to
                tests/fixtures/torch_port_real.json, every shard launching
                both kernels on its own stream; each shard's kernels
                against the plain version on an edge grid (its first and
                last target among the pairs, forward and reverse); and the
                largest sharded stage of each direction again, its wall on
                the card against the plain version shard by shard.  Prints
                the per-shard launches, pairs and kernel ms and the stages'
                wall ms;
 17. multihost -- the real set as 2 worker processes of 2 target shards,
                all on the one card (parallel/multihost.py, a gloo group):
                equal to torch_port_real.json, each rank launching K1 and
                K2 (its metrics file);
 18. gff     -- contigs plus GFF3 (synth.py --gff): small through
                createsetdb --gff-dir and clustersearch, equal to
                tests/fixtures/torch_port_small_gff.tsv byte for byte; the
                real set's ingest equal to torch_port_real_gff.json's
                digest, and its clustersearch (counters reset just before
                and read just after) held to the self-hit invariant;
 19. nucl    -- search --search-type 3 on the nucleotide contigs
                (synth.py --nucl), equal to torch_port_small_nucl.tsv;
 20. entry   -- spacedust_tpu_torch/entry.py: entry()'s sw_forward launch
                against the plain version, and dryrun_multichip(4) (the
                sharded and the 2-process clustersearch of the small set on
                the card, each equal to the single run);
 21. timing  -- each kernel against its plain version on the largest stage
                the real runs dispatched, with the main path's own resident
                tensors: equal outputs, milliseconds (the launches alone, by
                the events the wrapper records round them, and the wrapper's
                whole call with its host planning and job table copy) and
                GCUPS, beside the least time the card could take for the
                stage (bound_ms: the larger of its bytes over the memory
                rate and its integer instructions over the int32
                instruction rate).  For each stage also the longest pair
                alone and what the classes of query rows per lane buy.

The line before the last is the card's name and power limit, the one
before it a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import io
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
PHASES = ("kernels", "kernels-struct", "kernels-prof", "small", "real",
          "struct-small", "struct-real", "toolkit", "profile-small",
          "profile-real", "iterative-small", "iterative-real", "split",
          "sharded", "multihost", "gff", "nucl", "entry", "timing")
ALT_ALI = 2             # --alt-ali of the toolkit phase
# --split-memory-limit of the split phase (12 bytes a target residue; a
# profile position 2,048): 4 and 9 target splits of the small set, 4 of the
# real set (2,057,079 residues), 3-4 profile slices of the small set
SPLIT_BUDGETS_SMALL = (400_000, 150_000)
SPLIT_BUDGET_REAL = 7_000_000
SPLIT_BUDGET_PROFILE = 64_000_000
# The card's peaks (NVIDIA's H100 SXM data sheet): 3.35 TB/s of HBM, and
# 67 TFLOP/s of float32 outside the tensor cores = 132 SMs x 128 lanes x
# 2 (FMA) x 1.98 GHz.  An SM runs int32 on 64 lanes, one operation an
# instruction, so the int32 peak is a quarter of that figure.
HBM_BYTES_PER_S = 3.35e12
INT32_PER_S = 67e12 / 4
# int32 instructions the recurrence needs for a DP cell, whatever the body:
# lookup address, int8 wrap (add, sign extension), E (add, max-plus), H
# (max-plus-relu, max), F (add, max-plus), column max = 10; the reverse
# cell's tracker is compare, max, select in place of the column max = 12;
# the second channel of the structure cell adds its lookup address and its
# sum.  The profile cell reads its score from the query's profile row: no
# bias and no int8 wrap, so 10 - 2 = 8 forward and 12 - 2 = 10 reverse.
# What a body spends beside these (a mask for rows past qlen, register
# moves, shuffles) is its own cost and stands outside the bound.
CELL_INT32 = {"fwd": 10, "rev": 12, "fwd_struct": 12, "rev_struct": 14,
              "fwd_prof": 8, "rev_prof": 10}
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
                   "REVERSE_STRUCT_LAUNCHES"),
    "fwd_prof": ("sw_forward_prof", "spacedust_tpu/ops/sw.py:125",
                 "FORWARD_PROF_LAUNCHES"),
    "rev_prof": ("sw_reverse_prof", "spacedust_tpu/ops/sw.py:137",
                 "REVERSE_PROF_LAUNCHES")}
PROF_COLS = 21          # profile columns a residue (20 amino acids and X)
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


def tie_letters(sub: np.ndarray) -> tuple[int, int, list]:
    """A query filler, a target filler and three motif letters: the
    fillers score below 0 against each other and against every motif
    letter, and the motif letters below 0 against one another, so that a
    planted motif scores exactly its self-score and nothing extends it."""
    A = 20
    for fq in range(A):
        for ft in range(A):
            if sub[fq, ft] >= 0:
                continue
            ms: list = []
            for m in range(A):
                if (m not in (fq, ft) and sub[m, m] >= 5 and sub[m, ft] < 0
                        and sub[fq, m] < 0
                        and all(sub[m, o] < 0 for o in ms)):
                    ms.append(m)
            if len(ms) >= 3:
                return fq, ft, ms[:3]
    raise ValueError("no tie letters in this matrix")


def edge_batch(rows: int, sub: np.ndarray, seed: int = SEED, go: int = GO,
               bias_of=None):
    """Pairs that stress the kernels' body at `rows` query rows per lane
    (a strip is 32 * rows rows), for the letter scores `sub` and the gap
    open cost `go`.  Returns resident (q, bias, t), the (5, n) forward
    jobs and, for the planted ties, {pair: (score, t_end, q_end)}, the
    forward result the design must give.  The grid pairs' bias is random
    in -3..3, or bias_of(query) when given (a composition bias); the
    planted pairs have none.

    Grid: qlen in {1, rows, 32 rows - 1, 32 rows, 32 rows + 1, 64 rows,
    64 rows + 1, 96 rows + 7} x tlen in {1, 2, 7, 31, 32, 33, 100}, random
    with a mutated copy of a query segment as the target (a wavefront
    shorter than the warp, lanes and strips that end on every side of a
    boundary).  Ties (zero bias, two six-letter motifs M1 and M2 of one
    self-score among fillers that score below 0): the same column on
    either side of a lane boundary and of a strip boundary; the smaller
    column in the later lane, in the later strip, and in the same lane of
    the later strip; the smaller column in the earlier strip; and a
    three-strip query against an 8-residue target.  Gaps: a query insert
    that the best alignment bridges with one gap across a lane boundary,
    and across a strip boundary (F crosses by shuffle, and through the
    boundary scratch).  The reverse jobs derived from these hold a
    terminate score that first appears in a column whose max sits in the
    first strip while the last strip is a later one."""
    rng = np.random.default_rng(seed + rows)
    strip = 32 * rows
    qs, bs, ts = [], [], []
    for ql in (1, rows, strip - 1, strip, strip + 1, 2 * strip,
               2 * strip + 1, 3 * strip + 7):
        for tl in (1, 2, 7, 31, 32, 33, 100):
            q = rng.integers(0, 20, ql).astype(np.uint8)
            lo = int(rng.integers(0, max(ql - tl, 0) + 1))
            t = q[lo:lo + tl].copy()
            if len(t) < tl:
                t = np.concatenate([t, rng.integers(0, 20, tl - len(t))])
            hit = rng.integers(0, 100, tl) < 25
            t[hit] = rng.integers(0, 20, int(hit.sum()))
            qs.append(q)
            b = rng.integers(-3, 4, ql).astype(np.int8)
            bs.append(b if bias_of is None else bias_of(q))
            ts.append(t.astype(np.uint8))
    fq, ft, (a, b, c) = tie_letters(sub)
    motif = {1: [a, b, c, a, b, c], 2: [c, b, a, c, b, a]}
    score = 2 * int(sub[a, a] + sub[b, b] + sub[c, c])
    expect = {}

    def plant(qlen, tlen, q_ends, t_ends, want):
        q = np.full(qlen, fq, np.uint8)
        t = np.full(tlen, ft, np.uint8)
        for seq, ends in ((q, q_ends), (t, t_ends)):
            for end, m in ends:
                seq[end - 5:end + 1] = motif[m]
        expect[len(qs)] = (score, *want)
        qs.append(q)
        bs.append(np.zeros(qlen, np.int8))
        ts.append(t)

    lane_end = 2 * rows - 1            # last row of lane 1
    strip_end = strip - 2              # lane 31 of strip 0
    # one column, two rows: the earlier lane / strip keeps the tie
    plant(lane_end + 20, 20, [(lane_end, 1), (lane_end + 7, 1)], [(9, 1)],
          (9, lane_end))
    plant(strip + 20, 40, [(strip_end, 1), (strip + 8, 1)], [(33, 1)],
          (33, strip_end))
    # the smaller column sits in the later lane / strip
    plant(lane_end + 20, 30, [(lane_end, 2), (lane_end + 7, 1)],
          [(9, 1), (20, 2)], (9, lane_end + 7))
    plant(strip + 20, 40, [(strip_end, 2), (strip + 8, 1)],
          [(9, 1), (30, 2)], (9, strip + 8))
    plant(strip + lane_end + 10, 30, [(lane_end, 2), (strip + lane_end, 1)],
          [(9, 1), (20, 2)], (9, strip + lane_end))
    # the smaller column sits in the earlier strip (too far apart to chain)
    plant(strip + 110, 30, [(strip_end, 1), (strip + 100, 2)],
          [(9, 1), (17, 2)], (9, strip_end))
    # three strips, a target shorter than the warp
    plant(2 * strip + 10, 8, [(10, 1), (2 * strip + 3, 1)], [(5, 1)],
          (5, 10))
    # one gap over an insert of the query: within strip 0 across a lane
    # boundary, then across the strip boundary
    for start, n_ins in ((5, rows + 2), (strip - 35, 10)):
        left, right = (rng.integers(0, 20, 30).astype(np.uint8)
                       for _ in range(2))
        ins = rng.integers(0, 20, n_ins).astype(np.uint8)
        q = np.concatenate([np.full(start, fq), left, ins, right,
                            np.full(6, fq)]).astype(np.uint8)
        t = np.concatenate([np.full(3, ft), left, right,
                            np.full(3, ft)]).astype(np.uint8)
        gapped = (int(sub[left, left].sum() + sub[right, right].sum())
                  - go - GE * (n_ins - 1))
        expect[len(qs)] = (gapped, 3 + 60 - 1, start + 60 + n_ins - 1)
        qs.append(q)
        bs.append(np.zeros(len(q), np.int8))
        ts.append(t)
    qlen = np.array([len(q) for q in qs], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    qoff = np.concatenate(([0], np.cumsum(qlen)[:-1]))
    toff = np.concatenate(([0], np.cumsum(tlen)[:-1]))
    jobs = np.stack([qoff, qlen, toff, tlen, np.full(len(qs), -1)])
    return (np.concatenate(qs), np.concatenate(bs), np.concatenate(ts),
            np.ascontiguousarray(jobs, dtype=np.int64), expect)


# structure mode's edge batch: letter k of edge_batch stands for the token
# pair (3Di k, amino acid AA_OF[k]), so the two channels never hold the
# same array
AA_OF = (np.arange(20) + 7) % 20


def edge_batch_struct(rows: int, m3di: np.ndarray, aasc: np.ndarray,
                      seed: int = SEED):
    """edge_batch in two channels.  Returns resident (q_ss, q_aa, bias,
    t_ss, t_aa), the forward jobs and the planted ties' results.

    The batch is edge_batch's on the summed score of the letter pairs
    (k, AA_OF[k]), m3di[k, l] + aasc[AA_OF[k], AA_OF[l]], at structure
    mode's gap costs: motifs, fillers and the gapped pairs are chosen on
    that sum, so ties and gaps sit where edge_batch says.  Outside the
    planted pairs every fifth amino-acid token of either side is then
    redrawn from all 21 letters (the 21st included), so that the second
    channel also varies on its own."""
    comb = (m3di[:20, :20].astype(np.int32)
            + aasc[np.ix_(AA_OF, AA_OF)].astype(np.int32))
    q, b, t, jobs, expect = edge_batch(rows, comb, seed + 100, STRUCT_GO)
    qaa, taa = AA_OF[q].astype(np.uint8), AA_OF[t].astype(np.uint8)
    rng = np.random.default_rng(seed + 200 + rows)
    for p in range(jobs.shape[1]):
        if p in expect:
            continue
        for arr, off, n in ((qaa, *jobs[:2, p]), (taa, *jobs[2:4, p])):
            hit = rng.integers(0, 5, n) == 0
            arr[off:off + n][hit] = rng.integers(0, 21, int(hit.sum()))
    return [q, qaa, b, t, taa], jobs, expect


def kernel_batch_prof(sub: np.ndarray, seed: int = SEED):
    """Resident profile rows (flat, PROF_COLS a residue) and target tokens
    and a (5, n) forward job array: 2,000 ragged pairs of 1-3,000 residues
    (homologs, whose profiles are the query's substitution rows with noise
    and a mutated query segment as the target; planted ties, a motif twice
    in the target; zero-score pairs, every value -32; length-1 pairs;
    rows at the extremes -32 and 31), then a 9,000 x 9,000 and a 40,000 x
    600 homolog pair."""
    rng = np.random.default_rng(seed + 2)
    n = 2000
    ql = np.minimum(np.exp(rng.uniform(0, np.log(3000), n)), 3000)
    tl = np.minimum(np.exp(rng.uniform(0, np.log(3000), n)), 3000)
    ql, tl = ql.astype(np.int64), tl.astype(np.int64)
    ql[:8] = 1
    tl[8:16] = 1
    ql[16:20] = tl[16:20] = 1

    def profile(q):
        prof = sub[q].astype(np.int32) + rng.integers(-3, 4, (len(q),
                                                              PROF_COLS))
        return np.clip(prof, -32, 31).astype(np.int8)

    ps, ts = [], []
    for p in range(n):
        q = rng.integers(0, 21, ql[p]).astype(np.uint8)
        prof = profile(q)
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
            prof[:] = -32                             # every cell < 0
        elif kind == 5:                               # the extremes
            prof = np.where(rng.integers(0, 2, prof.shape) == 1, 31,
                            -32).astype(np.int8)
        ps.append(prof)
        ts.append(t)
    for qlen, tlen in ((9000, 9000), (40000, 600)):
        q = rng.integers(0, 20, qlen).astype(np.uint8)
        lo = (qlen - tlen) // 2
        ps.append(profile(q))
        ts.append(_mutate(rng, q[lo:lo + tlen], 25)[:tlen])
    qlen = np.array([len(x) for x in ps], np.int64)
    tlen = np.array([len(t) for t in ts], np.int64)
    qoff = np.concatenate(([0], np.cumsum(qlen)[:-1]))
    toff = np.concatenate(([0], np.cumsum(tlen)[:-1]))
    jobs = np.stack([qoff, qlen, toff, tlen, np.full(len(ps), -1)])
    return ([np.concatenate(ps).reshape(-1), np.concatenate(ts)],
            np.ascontiguousarray(jobs, dtype=np.int64))


def edge_batch_prof(rows: int, sub: np.ndarray, seed: int = SEED):
    """edge_batch as profile rows: residue i of a query becomes the row
    sub[q_i] + bias_i (cast to int8).  Off the planted pairs every row
    also gets noise in -3..3 on all 21 values, so that the cell is not
    the sequence cell in disguise.  Returns resident (profile rows,
    targets), the forward jobs and the planted ties' results."""
    q, b, t, jobs, expect = edge_batch(rows, sub, seed + 300)
    prof = (sub[q].astype(np.int32) + b[:, None]).astype(np.int8)
    rng = np.random.default_rng(seed + 400 + rows)
    for p in range(jobs.shape[1]):
        if p in expect:
            continue
        off, n = jobs[:2, p]
        noise = rng.integers(-3, 4, (n, PROF_COLS))
        prof[off:off + n] = (prof[off:off + n] + noise).astype(np.int8)
    return [prof.reshape(-1), t], jobs, expect


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
    from spacedust_tpu_torch.ops.sw import (sw_jobs_ref, sw_prof_jobs_ref,
                                            sw_struct_jobs_ref)
    ref = (sw_struct_jobs_ref if d.endswith("struct")
           else sw_prof_jobs_ref if d.endswith("prof") else sw_jobs_ref)
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


def check_edges(tables: list, errs: dict, cell: str = "seq",
                bias_of=None, tag: str | None = None) -> None:
    """Each compiled class of the kernels' body on edge_batch (cell "seq",
    tables: [sub], the grid pairs' bias from bias_of when given),
    edge_batch_struct ("struct", tables: [m3di, aasc]) or edge_batch_prof
    ("prof", tables: [sub], from which the profile rows are made), on the
    card, every pair forced into the class (a plan of one class, handed
    to the wrappers' launcher); the planted ties where the design puts
    them."""
    from spacedust_tpu_torch.ops import sw_cuda
    tabs = [m.cpu().numpy().astype(np.int32) for m in tables]
    d_fwd, d_rev, go, tag0 = {
        "seq": ("fwd", "rev", GO, "kernels"),
        "struct": ("fwd_struct", "rev_struct", STRUCT_GO, "kernels-struct"),
        "prof": ("fwd_prof", "rev_prof", GO, "kernels-prof")}[cell]
    tag = tag or tag0
    for rows in sw_cuda.LANE_ROWS:
        if cell == "struct":
            arrays, jobs, expect = edge_batch_struct(rows, *tabs)
        elif cell == "prof":
            arrays, jobs, expect = edge_batch_prof(rows, *tabs)
        else:
            *arrays, jobs, expect = edge_batch(rows, *tabs, bias_of=bias_of)
        res = [torch.from_numpy(a).to(tables[0].device) for a in arrays]
        if cell != "prof":
            res += tables

        def both(d, js, what):
            reverse = d == d_rev
            got = sw_cuda._launch_warp(reverse, res, sw_cuda.warp_plan(
                js, sw_cuda.WARP_SCRATCH[reverse], rows=rows), go, GE)
            ref = plain(d)(*res, js, go, GE)
            errs[d] = max(errs[d], compare(f"{tag} edges R={rows} {what}",
                                           got, ref))
            return got

        fwd = both(d_fwd, jobs, d_fwd).cpu().numpy()
        for p, want in expect.items():
            if tuple(fwd[:3, p]) != want:
                fail(f"edges R={rows} {d_fwd}: planted tie {p} gave "
                     f"{tuple(fwd[:3, p])}, the design says {want}")
        whole = jobs.copy()
        whole[4] = fwd[0]
        derived = reverse_jobs(jobs, fwd)
        n_multi = int((derived[1] > 32 * rows).sum())
        if n_multi < 4:
            fail(f"edges R={rows}: only {n_multi} multi-strip reverse jobs")
        both(d_rev, whole, f"{d_rev} whole")
        got = both(d_rev, derived, f"{d_rev} prefix")
        if not bool(got[3].all()):
            fail(f"edges R={rows}: a prefix job missed its terminate score")
        print(f"[{tag}] edges R={rows}: {jobs.shape[1]} forward, "
              f"{whole.shape[1]} + {derived.shape[1]} reverse pairs "
              f"({n_multi} multi-strip), {len(expect)} planted ties: all "
              f"six outputs equal")


def composition_bias(matrix):
    """bias_of(q) for edge_batch: the int8 composition bias of one query
    under `matrix` (the native routine the alignment engine calls)."""
    from spacedust_tpu_torch.native import comp_bias_batch

    def bias_of(q: np.ndarray) -> np.ndarray:
        return comp_bias_batch(
            np.ascontiguousarray(q, dtype=np.uint8), np.zeros(1, np.int64),
            np.array([len(q)], np.int32),
            np.ascontiguousarray(matrix.sub_int, dtype=np.int32),
            np.ascontiguousarray(matrix.p_back, dtype=np.float64))
    return bias_of


def check_kernels(sub: torch.Tensor, errs: dict) -> None:
    """K1/K2 on the seeded batch and the edge batches with BLOSUM62, then
    with the iterative search's realignment matrix (blosum62_bf2_bias)
    and the composition bias it gives each query: the sequence kernels
    score with any 21-letter table they are handed, and the int8 wrap of
    table + bias must agree with the plain version for this one too."""
    from spacedust_tpu_torch.native import comp_bias_batch
    from spacedust_tpu_torch.stats.submat import load_pinned_matrix
    q, b, t, jobs = kernel_batch()
    Q, B, T = (torch.from_numpy(a).to(sub.device) for a in (q, b, t))
    check_batch("kernels", [Q, B, T, sub], jobs, GO, ("fwd", "rev"), errs)
    check_edges([sub], errs)
    m = load_pinned_matrix("blosum62_bf2_bias")
    rsub = torch.from_numpy(m.sub_int.astype(np.int8)).to(sub.device)
    rb = comp_bias_batch(q, np.ascontiguousarray(jobs[0]),
                         np.ascontiguousarray(jobs[1], dtype=np.int32),
                         np.ascontiguousarray(m.sub_int, dtype=np.int32),
                         np.ascontiguousarray(m.p_back, dtype=np.float64))
    # the pairs of kernel_batch's kinds 4 and 5 keep their extreme bias
    for p in range(jobs.shape[1] - 2):
        if p % 8 in (4, 5):
            o, n = jobs[0, p], jobs[1, p]
            rb[o:o + n] = b[o:o + n]
    if int(np.abs(rb).max()) < 100 or (rb != 0).mean() < 0.05:
        fail("kernels realign: the composition bias lost its shape")
    check_batch("kernels realign", [Q, torch.from_numpy(rb).to(sub.device),
                                    T, rsub], jobs, GO, ("fwd", "rev"), errs)
    check_edges([rsub], errs, bias_of=composition_bias(m),
                tag="kernels realign")


def check_kernels_prof(sub: torch.Tensor, errs: dict) -> None:
    arrays, jobs = kernel_batch_prof(sub.cpu().numpy().astype(np.int32))
    resident = [torch.from_numpy(a).to(sub.device) for a in arrays]
    check_batch("kernels-prof", resident, jobs, GO, ("fwd_prof", "rev_prof"),
                errs)
    check_edges([sub], errs, cell="prof")


def check_kernels_struct(dev: torch.device, errs: dict) -> None:
    from spacedust_tpu_torch.search.structure import combined_matrices
    arrays, jobs = kernel_batch_struct()
    m3di, aasc, _ = combined_matrices()
    tables = [torch.from_numpy(m.astype(np.int8)).to(dev)
              for m in (m3di, aasc)]
    resident = [torch.from_numpy(a).to(dev) for a in arrays] + tables
    check_batch("kernels-struct", resident, jobs, STRUCT_GO,
                ("fwd_struct", "rev_struct"), errs)
    check_edges(tables, errs, cell="struct")


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
        def call(*args, **kw):
            if (d not in stages
                    or args[-3].shape[1] > stages[d][-3].shape[1]):
                stages[d] = args
            return fn(*args, **kw)
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
        need = (("fwd", "rev", "fwd_struct", "rev_struct") if mode == 1
                else ("fwd_struct", "rev_struct"))
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


def self_hits_ok(db, tmp: Path, among=None) -> int:
    """Every gene of >= 100 aa (of `among`, default all) finds itself with
    E < 1e-10 in the result checkpoint (the per-query alignment records);
    returns the count."""
    from spacedust_tpu_torch.db.mmseqs_io import FlatDB
    res = FlatDB.open(next(tmp.glob("*/result.index")).with_suffix(""))
    keys = set(res.keys())
    missing = []
    long = np.nonzero(db.lengths >= 100)[0]
    if among is not None:
        long = np.intersect1d(long, np.asarray(among, dtype=np.int64))
    for k in long.tolist():
        lines = res.lines(k) if k in keys else []
        if not any(int(c[0]) == k and float(c[3]) < 1e-10
                   for c in (ln.split("\t") for ln in lines)):
            missing.append(k)
    if missing:
        fail(f"{len(missing)} genes of >= 100 aa lack a self hit with "
             f"E < 1e-10 (first: {missing[:5]})")
    return len(long)


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
    detail = tm["align_detail"]
    hits, clusters = counts(res.tsv)
    print(f"[struct-{size}] {db.size} genes, {len(db.seq_data)} residues; "
          f"createsetdb {t_ingest:.2f} s; clustersearch {t_search:.2f} s = "
          f"structure_search {tm['structure_search']:.2f} (3Di index "
          f"{detail['index_s']:.2f}, prefilter {detail['prefilter_s']:.2f}, "
          f"align_all {detail['align_all_s']:.2f}) + aggregate "
          f"{tm['aggregate']:.2f}")
    print(f"[struct-{size}] align detail {json.dumps(detail)}")
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

# ------------------------------------------------------------- 9. toolkit
def check_masked_targets(sub: torch.Tensor, errs: dict) -> None:
    """sw_forward / sw_reverse over explicit targets: the seeded ragged
    pairs of kernel_batch, each against a masked copy of its target that
    lies in a second array (in reverse pair order, so no offset is the
    resident one), with the resident queries."""
    from spacedust_tpu_torch.constants import X_INDEX
    from spacedust_tpu_torch.ops import sw_cuda
    q, b, t, jobs = kernel_batch()
    jobs = jobs[:, :2000].copy()             # without the two giant pairs
    resident_toff = jobs[2].copy()
    copies = []
    for p in range(jobs.shape[1]):
        toff, tl = int(jobs[2, p]), int(jobs[3, p])
        c = t[toff:toff + tl].copy()
        k = max(tl // 3, 1)
        lo, hi = ((0, k), (tl // 3, tl // 3 + k), (max(tl - 1 - k, 0), tl - 1),
                  (0, tl))[p % 4]
        c[lo:hi] = X_INDEX
        copies.append(c)
    order = np.arange(jobs.shape[1])[::-1]
    lens = jobs[3, order]
    jobs[2, order] = np.cumsum(lens) - lens
    tm = np.concatenate([copies[p] for p in order])
    n_x = int((tm == X_INDEX).sum())
    if n_x < len(tm) // 4 or (jobs[2] == resident_toff).sum() > 1:
        fail("the masked target array lost its shape")
    res = [torch.from_numpy(a).to(sub.device) for a in (q, b, tm)] + [sub]
    fwd = None
    for d in ("fwd", "rev"):
        js = jobs if fwd is None else reverse_jobs(jobs, fwd)
        got = getattr(sw_cuda, KERNELS[d][0])(*res, js, GO, GE)
        ref = plain(d)(*res, js, GO, GE)
        errs[d] = max(errs[d], compare(f"toolkit masked targets {d}", got,
                                       ref))
        out = got.cpu().numpy()
        if fwd is None:
            fwd = out
        elif not out[3].all():
            fail("toolkit: a reverse job over masked targets missed its "
                 "terminate score")
        print(f"[toolkit] {d} over explicit masked targets: {js.shape[1]} "
              f"pairs, {cells(js) / 1e6:.1f} M cells, {n_x} of {len(tm)} "
              f"target residues masked, all six outputs equal")
    if int((fwd[0] > 0).sum()) < 500:
        fail("toolkit: too few masked pairs score above 0")


def run_cli(argv: list, quiet: bool = False) -> str:
    """cli.main(argv), fatal on a non-zero return; returns what it
    printed (and prints it unless quiet)."""
    from spacedust_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if not quiet:
        print(buf.getvalue(), end="")
    if rc != 0:
        fail(f"{' '.join(argv[:1])} failed: {argv}")
    return buf.getvalue()


def toolkit_set(work: Path, size: str) -> None:
    """Every command of the toolkit on a recorded set, each file held
    against its fixture, and the chain against clustersearch."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.workflow.modules import toolkit_commands
    t0 = time.perf_counter()
    fa = synth.write_genome_set(work / f"tk_{size}", size)
    db, out = str(work / f"tk_{size}_db"), work / f"tk_{size}_out"
    out.mkdir()
    run_cli(["createsetdb", *map(str, fa), db])
    before = read_counts()
    for name, argv in toolkit_commands(db, out):
        run_cli(argv + (["--device", "cuda"] if argv[0] == "search" else []))
        fixture = ROOT / "tests" / "fixtures" / f"torch_port_{size}_{name}"
        if (out / name).read_bytes() != fixture.read_bytes():
            fail(f"toolkit {size}: {argv[0]} wrote a {name} that differs "
                 f"from {fixture.name}")
    launched = {d: n - before[d] for d, n in read_counts().items()}
    tsv = out / "clustersearch.tsv"
    run_cli(["clustersearch", db, db, str(tsv), "--filter-self-match",
             "--device", "cuda"])
    if tsv.read_bytes() != (out / "chain_result.tsv").read_bytes():
        fail(f"toolkit {size}: the chain's result differs from "
             f"clustersearch's TSV")
    print(f"[toolkit] {size}: 9 files equal to the JAX fixtures, the chain "
          f"equal to clustersearch ({counts(tsv.read_text())[0]} hits); "
          f"launches of the three searches {launched} "
          f"({time.perf_counter() - t0:.1f} s)")


def toolkit_real(work: Path) -> dict:
    """`search --alt-ali 2` at real size, held to its invariants; returns
    the launch counts of that run."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.ops import sw_cuda
    fa = (synth.write_genome_set(work / "tk_real", "real")
          + synth.write_genome_set(work / "tk_real_repeats", "repeats"))
    db = str(work / "tk_real_db")
    run_cli(["createsetdb", *map(str, fa), db])
    runs = {}
    for tag, flags in (("base", []), ("alt", ["--alt-ali", str(ALT_ALI)])):
        out = work / f"tk_real_{tag}.tsv"
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        text = run_cli(["search", db, db, str(out), *flags, "--device",
                        "cuda"])
        torch.cuda.synchronize()
        detail = next(json.loads(ln.split("detail: ", 1)[1])
                      for ln in text.splitlines() if "detail: " in ln)
        runs[tag] = (out.read_text().splitlines(), read_counts(), detail,
                     time.perf_counter() - t0)
    base, base_launches, _, t_base = runs["base"]
    lines, launches, detail, t_alt = runs["alt"]

    # without its alternative records the result is the plain search's
    left = collections.Counter(base)
    kept, alts = [], []
    for ln in lines:
        if left[ln] > 0:
            left[ln] -= 1
            kept.append(ln)
        else:
            alts.append(ln)
    if kept != base:
        fail("toolkit real: --alt-ali changed or reordered the records of "
             "the search without it")
    if len(alts) < 10:
        fail(f"toolkit real: only {len(alts)} alternative records")
    # each chain: the parent first (it is in the plain search), then the
    # alternative records; a record lies off every range masked before it
    by_pair = collections.defaultdict(list)
    for ln in base:
        c = ln.split("\t")
        by_pair[c[0], c[1]].append((int(c[8]), int(c[9])))
    chain_len = collections.Counter()
    for ln in alts:
        c = ln.split("\t")
        key, evalue = (c[0], c[1]), float(c[4])
        tstart, tend = int(c[8]), int(c[9])
        if key not in by_pair or c[0] == c[1]:
            fail(f"toolkit real: alternative record without a parent: {ln}")
        if not evalue <= 1e-3:
            fail(f"toolkit real: alternative record past the E-value gate: "
                 f"{ln}")
        for lo, hi in by_pair[key]:
            if tstart < hi and tend >= lo:
                fail(f"toolkit real: alternative record {ln} overlaps the "
                     f"masked range [{lo}, {hi})")
        chain_len[key] += 1
    for key, n in chain_len.items():
        if n > ALT_ALI:
            fail(f"toolkit real: {n} alternative records for {key}")
        # the records of a chain lie off one another as well
        spans = sorted((int(c[8]), int(c[9])) for c in
                       (ln.split("\t") for ln in alts)
                       if (c[0], c[1]) == key)
        if any(a[1] > b[0] for a, b in zip(spans, spans[1:])):
            fail(f"toolkit real: the alternative records of {key} overlap")
    extra = {d: launches[d] - base_launches[d] for d in ("fwd", "rev")}
    alt = detail["alt_detail"]
    if not all(1 <= extra[d] <= ALT_ALI for d in extra):
        fail(f"toolkit real: the masked rounds launched {extra} beyond the "
             f"main pass ({base_launches}), not 1 to {ALT_ALI} a direction")
    if (alt["fwd_launches"], alt["rev_launches"]) != (extra["fwd"],
                                                      extra["rev"]):
        fail(f"toolkit real: the engine counted {alt['fwd_launches']} + "
             f"{alt['rev_launches']} launches in the rounds, the wrappers "
             f"{extra}")
    print(f"[toolkit] real + repeats, search --alt-ali {ALT_ALI}: "
          f"{len(base)} records + {len(alts)} alternative in "
          f"{len(chain_len)} chains ({t_alt:.2f} s; without the flag "
          f"{t_base:.2f} s); invariants hold")
    print(f"[toolkit] masked rounds: launches {launches} (main pass alone "
          f"{base_launches}); pairs a round {alt['round_pairs']}; forward "
          f"{alt['fwd_pairs']} pairs / {alt['fwd_cells']} cells, kernel "
          f"{alt['fwd_kernel_ms']:.3f} ms (wrapper "
          f"{alt['fwd_wrapper_ms']:.3f}); reverse {alt['rev_pairs']} pairs "
          f"/ {alt['rev_cells']} cells, kernel {alt['rev_kernel_ms']:.3f} ms "
          f"(wrapper {alt['rev_wrapper_ms']:.3f}); stage seconds: prefilter "
          f"{detail['prefilter_s']:.2f}, align {detail['align_s']:.2f} (of "
          f"it the rounds {alt['rounds_s']:.2f}); main pass kernel "
          f"{detail['align_detail']['fwd_kernel_ms']:.2f} + "
          f"{detail['align_detail']['rev_kernel_ms']:.2f} ms")
    return launches


def toolkit_phase(work: Path, sub: torch.Tensor, errs: dict) -> dict:
    check_masked_targets(sub, errs)
    for size in ("small", "repeats"):
        toolkit_set(work, size)
    return toolkit_real(work)


# ------------------------------------------------- 11-12. profile search
def cdb_differs(got, want) -> str | None:
    """Where two ClusterDBs differ (None when they are equal): clusters,
    representatives, every array with its dtype, the clu_aln lines."""
    if got.clusters != want.clusters or got.rep_keys != want.rep_keys:
        return "clusters"
    for name in ("pssms", "aln_profiles", "consensus", "query_seqs"):
        a, b = getattr(got, name), getattr(want, name)
        for k in want.rep_keys:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                return f"{name} of representative {k}"
    for k in want.rep_keys:
        if ([r.line() for r in got.clu_aln[k]]
                != [r.line() for r in want.clu_aln[k]]):
            return f"clu_aln of representative {k}"
    return None


def profile_small(work: Path) -> None:
    """clusterdb (both clusterings) and the profile cluster search through
    the CLI on the small set, against the JAX-recorded fixtures."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.workflow.clusterdb import ClusterDB
    fixtures = ROOT / "tests" / "fixtures"
    t0 = time.perf_counter()
    fa = synth.write_genome_set(work / "prof_small", "small")
    db = str(work / "prof_small_db")
    run_cli(["createsetdb", *map(str, fa), db])
    before = read_counts()
    for out, flags, name in (
            (db + "_clu", [], "torch_port_small_clu"),
            (str(work / "prof_small_cascade"),
             ["--single-step-clustering", "0"],
             "torch_port_small_clu_cascade")):
        run_cli(["clusterdb", db, out, *flags, "--device", "cuda"])
        where = cdb_differs(ClusterDB.load(out), ClusterDB.load(fixtures
                                                                 / name))
        if where:
            fail(f"profile-small: clusterdb {flags} differs from {name} in "
                 f"{where}")
    want = (fixtures / "torch_port_small_profile.tsv").read_bytes()
    for cdir in (db + "_clu", fixtures / "torch_port_small_clu"):
        out = work / "prof_small.tsv"
        run_cli(["clustersearch", db, db, str(out), "--filter-self-match",
                 "--profile-cluster-search", "--cluster-db", str(cdir),
                 "--device", "cuda"])
        if out.read_bytes() != want:
            fail(f"profile-small: the TSV over {cdir} differs from "
                 f"torch_port_small_profile.tsv")
    launched = {d: n - before[d] for d, n in read_counts().items()}
    if any(launched[d] <= 0 for d in ("fwd", "rev", "fwd_prof", "rev_prof")):
        fail(f"profile-small did not launch K1/K2 and both prof kernels: "
             f"{launched}")
    print(f"[profile-small] clusterdb (both clusterings) equal to the JAX "
          f"directories; the profile search over the port's and over the "
          f"JAX-written ClusterDB equal to the JAX TSV "
          f"({counts(want.decode())[0]} hits); launches {launched} "
          f"({time.perf_counter() - t0:.1f} s)")


def profile_real(work: Path, dev: torch.device) -> tuple[dict, dict]:
    """clusterdb and the profile cluster search at real size, held to
    invariants.  Returns the launch counts of the run and the largest
    profile stages."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.workflow.clusterdb import cluster_db
    from spacedust_tpu_torch.workflow.clustersearch import (
        ClusterSearchParams, cluster_search_to_file)
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    fa = synth.write_genome_set(work / "prof_real", "real")
    db = create_setdb([str(p) for p in fa], str(work / "prof_real_db"))
    tmp = work / "prof_real_tmp"
    stages: dict = {}
    with recording(stages, ("fwd_prof", "rev_prof")):
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        cm: dict = {}
        cdb = cluster_db(db, device=dev, metrics=cm)
        torch.cuda.synchronize()
        t_cdb = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = cluster_search_to_file(
            db, db, str(work / "prof_real.tsv"), str(tmp),
            params=ClusterSearchParams(filter_self_match=True,
                                       profile_cluster_search=True),
            target_cluster_db=cdb, device=dev)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = read_counts()
    if any(launches[d] <= 0 for d in ("fwd", "rev", "fwd_prof", "rev_prof")):
        fail(f"profile-real did not launch K1/K2 and both prof kernels: "
             f"{launches}")
    keys = sorted(k for ms in cdb.clusters.values() for k in ms)
    if keys != list(range(db.size)) or sorted(cdb.clusters) != cdb.rep_keys:
        fail("profile-real: the clusters do not hold every key exactly once")
    no_self = [r for r in cdb.rep_keys
               if not any(a.tkey == r for a in cdb.clu_aln[r])]
    if no_self:
        fail(f"profile-real: {len(no_self)} representatives lack their self "
             f"alignment in clu_aln (first: {no_self[:5]})")
    n_self = self_hits_ok(db, tmp, among=cdb.rep_keys)
    tm = res.timings
    pd = tm["profile_detail"]
    ad = pd["align_detail"]
    hits, clusters = counts(res.tsv)
    sizes = collections.Counter(len(v) for v in cdb.clusters.values())
    print(f"[profile-real] {db.size} genes, {len(db.seq_data)} residues; "
          f"clusterdb {t_cdb:.2f} s = clustering {cm['cluster_s']:.2f} "
          f"(prefilter {cm['prefilter_s']:.2f}, align {cm['align_s']:.2f}) + "
          f"profiles {cm['profiles_s']:.2f} + clu_aln {cm['clu_aln_s']:.2f}; "
          f"{len(cdb.rep_keys)} clusters, {sum(n for k, n in sizes.items() if k > 1)} "
          f"with several members (largest {max(sizes)})")
    print(f"[profile-real] profile cluster search {t_search:.2f} s = "
          f"profile index {pd['index_s']:.2f} + match {pd['match_s']:.2f} "
          f"+ align {pd['align_s']:.2f} + swap {pd['swap_s']:.2f} + expand "
          f"{tm['expandaln']:.2f} + aggregate {tm['aggregate']:.2f}")
    print(f"[profile-real] profile align detail {json.dumps(ad)}")
    print(f"[profile-real] clustering align detail "
          f"{json.dumps(cm['cluster_align_detail'])}")
    print(f"[profile-real] launches {launches}; {hits} hits / {clusters} "
          f"clusters, canonical sha256 {canonical_sha256(res.tsv)}; every "
          f"key in one cluster, every clu_aln with its self alignment, "
          f"{n_self} representatives of >= 100 aa find their own profile "
          f"with E < 1e-10; no JAX fixture at this size (its numpy profile "
          f"index would hold ~1.2e9 postings)")
    return launches, stages


# ------------------------------------------- 13-15. iterative and split
def detail_of(text: str) -> dict:
    """The JSON of a command's `detail:` line."""
    return next(json.loads(ln.split("detail: ", 1)[1])
                for ln in text.splitlines() if "detail: " in ln)


def round_line(tag: str, m: dict) -> str:
    """One round of search_iterative's metrics: stage seconds, counts and
    each SW engine's pairs, cells, launches and kernel / wrapper ms."""
    engines = "; ".join(
        f"{key} {d['fwd_pairs']} + {d['rev_pairs']} pairs, "
        f"{d['fwd_cells'] / 1e9:.3f} + {d['rev_cells'] / 1e9:.3f} G cells, "
        f"{d['fwd_launches']} + {d['rev_launches']} launches, kernel "
        f"{d['fwd_kernel_ms']:.2f} + {d['rev_kernel_ms']:.2f} ms (wrapper "
        f"{d['fwd_wrapper_ms']:.2f} + {d['rev_wrapper_ms']:.2f})"
        for key, d in m.items() if key.endswith("_detail"))
    return (f"[{tag}] round {m['round']}: index {m['index_s']:.2f} s "
            f"({m['index_mb']:.1f} MB), prefilter {m['prefilter_s']:.2f} s, "
            f"{m['candidates']} candidates, align {m['align_s']:.2f} s, "
            f"{m['records']} records, profiles "
            f"{m.get('profiles_s', 0.0):.2f} s; {engines}")


def iterative_small(work: Path) -> None:
    """search --num-iterations through the CLI on the small set (2 and 3)
    and the family set (2), each TSV equal to its JAX fixture."""
    from spacedust_tpu_torch import synth
    t0 = time.perf_counter()
    before = read_counts()
    for size, iters in (("small", (2, 3)), ("families", (2,))):
        fa = synth.write_genome_set(work / f"it_{size}", size)
        db = str(work / f"it_{size}_db")
        run_cli(["createsetdb", *map(str, fa), db], quiet=True)
        for n in iters:
            out = work / f"it_{size}_{n}.tsv"
            rounds = detail_of(run_cli(
                ["search", db, db, str(out), "--num-iterations", str(n),
                 "--device", "cuda"], quiet=True))["rounds"]
            name = f"torch_port_{size}_iter{n}.tsv"
            if out.read_bytes() != (ROOT / "tests" / "fixtures"
                                    / name).read_bytes():
                fail(f"iterative-small: search --num-iterations {n} on "
                     f"{size} differs from {name}")
            print(f"[iterative-small] {size}, {n} iterations: records a "
                  f"round {[m['records'] for m in rounds]}, equal to {name}")
    launched = {d: k - before[d] for d, k in read_counts().items()}
    if any(launched[d] <= 0 for d in ("fwd", "rev", "fwd_prof", "rev_prof")):
        fail(f"iterative-small did not launch K1/K2 and both prof kernels: "
             f"{launched}")
    print(f"[iterative-small] launches {launched} "
          f"({time.perf_counter() - t0:.1f} s)")


def peak_rss_mb() -> float:
    """The process's peak resident set so far (getrusage), in MB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mb() -> float:
    """The process's resident set now (/proc/self/statm), in MB."""
    import os
    pages = int(Path("/proc/self/statm").read_text().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def iterative_real(work: Path) -> dict:
    """search --num-iterations 2 through the CLI at real size, counters
    reset just before and read just after, held to invariants; returns
    the launch counts of the run."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.db.setdb import SetDB
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.search import alignment, iterative
    e_profile = 0.1                       # the CLI's default --e-profile
    fa = synth.write_genome_set(work / "it_real", "real")
    db_path = str(work / "it_real_db")
    run_cli(["createsetdb", *map(str, fa), db_path], quiet=True)
    db = SetDB.load(db_path)
    out = work / "it_real.tsv"
    # where round 0 ends in each query's list, and what the acceptance
    # pass gave, taken on their way through the library
    n0: dict = {}
    accepted: dict = {}
    rss: list = []                 # resident set after each round's index
    build = iterative.build_profiles
    forward_accepts = alignment.AlignmentEngine.forward_accepts
    engine = iterative.PrefilterEngine

    class Measured(engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            rss.append(rss_mb())

    def counting(qdb, tdb, records, eval_profile):
        n0.update({qk: len(v) for qk, v in records.items()})
        return build(qdb, tdb, records, eval_profile)

    def keeping(self, *args, **kw):
        res = forward_accepts(self, *args, **kw)
        accepted.update(res)
        return res

    iterative.build_profiles = counting
    alignment.AlignmentEngine.forward_accepts = keeping
    iterative.PrefilterEngine = Measured
    try:
        rss0, peak0 = rss_mb(), peak_rss_mb()
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        text = run_cli(["search", db_path, db_path, str(out),
                        "--num-iterations", "2", "--device", "cuda"],
                       quiet=True)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = read_counts()
    finally:
        iterative.build_profiles = build
        alignment.AlignmentEngine.forward_accepts = forward_accepts
        iterative.PrefilterEngine = engine
    peak = peak_rss_mb()
    if any(launches[d] <= 0 for d in ("fwd", "rev", "fwd_prof", "rev_prof")):
        fail(f"iterative-real did not launch K1/K2 and both prof kernels: "
             f"{launches}")
    lines = collections.defaultdict(list)
    for ln in out.read_text().splitlines():
        c = ln.split("\t")
        lines[int(c[0])].append(c)
    no_self, again, changed, n1 = [], [], [], 0
    for qk in range(db.size):
        cols = lines.get(qk, [])
        r0, r1 = cols[:n0.get(qk, 0)], cols[n0.get(qk, 0):]
        n1 += len(r1)
        if db.lengths[qk] >= 100 and not any(
                int(c[1]) == qk and float(c[4]) < 1e-10 for c in cols):
            no_self.append(qk)
        found = {int(c[1]) for c in r0 if float(c[4]) <= e_profile}
        again += [(qk, int(c[1])) for c in r1 if int(c[1]) in found]
        fwd = {r.tkey: r.columns() for r in accepted.get(qk, [])}
        changed += [(qk, int(c[1])) for c in r0
                    if int(c[1]) not in fwd
                    or (c[2], c[4]) != (fwd[int(c[1])][1],
                                        fwd[int(c[1])][3])]
    if no_self:
        fail(f"iterative-real: {len(no_self)} genes of >= 100 aa lack a self "
             f"hit with E < 1e-10 (first: {no_self[:5]})")
    if again:
        fail(f"iterative-real: round 1 aligned {len(again)} targets that "
             f"round 0 had found at E <= {e_profile} (first: {again[:5]})")
    if changed:
        fail(f"iterative-real: {len(changed)} round-0 records do not carry "
             f"the acceptance pass's score and E-value (first: "
             f"{changed[:5]})")
    n_all = sum(len(v) for v in lines.values())
    rounds = detail_of(text)["rounds"]
    print(f"[iterative-real] {db.size} genes, {len(db.seq_data)} residues; "
          f"search --num-iterations 2 {t_search:.2f} s; {n_all} records, "
          f"{n_all - n1} of round 0 and {n1} of round 1")
    for m in rounds:
        print(round_line("iterative-real", m))
    print(f"[iterative-real] launches {launches}; resident set "
          f"{rss0:.0f} MB before the run, "
          f"{', '.join(f'{x:.0f}' for x in rss)} MB after each round's "
          f"index; the process's peak {peak:.0f} MB after the run "
          f"({peak0:.0f} MB before it); "
          f"every gene of >= 100 aa finds itself with E < 1e-10, round 1 "
          f"aligns no target round 0 found at E <= {e_profile}, round 0's "
          f"records carry the acceptance pass's score and E-value")
    return launches


def split_phase(work: Path, dev: torch.device) -> dict:
    """--split-memory-limit: the sequence search at two budgets and the
    sliced profile search on the small set through the CLI, each equal to
    the unsplit JAX fixture; the sequence search at real size in 3-4
    target splits through cluster_search_to_file, counters reset just
    before and read just after, equal to the unsplit fixture.  Returns the
    launch counts of that run."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.parallel.split import splits_for_memory_budget
    from spacedust_tpu_torch.workflow.clustersearch import (
        ClusterSearchParams, cluster_search_to_file)
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    fixtures = ROOT / "tests" / "fixtures"
    t0 = time.perf_counter()
    fa = synth.write_genome_set(work / "split_small", "small")
    db = str(work / "split_small_db")
    run_cli(["createsetdb", *map(str, fa), db], quiet=True)
    runs = [(["--split-memory-limit", str(b)], "torch_port_small.tsv")
            for b in SPLIT_BUDGETS_SMALL]
    runs.append((["--profile-cluster-search", "--cluster-db",
                  str(fixtures / "torch_port_small_clu"),
                  "--split-memory-limit", str(SPLIT_BUDGET_PROFILE)],
                 "torch_port_small_profile.tsv"))
    for flags, name in runs:
        out = work / "split_small.tsv"
        detail = detail_of(run_cli(
            ["clustersearch", db, db, str(out), "--filter-self-match",
             *flags, "--device", "cuda"], quiet=True))
        if out.read_bytes() != (fixtures / name).read_bytes():
            fail(f"split: {' '.join(flags)} on small differs from {name}")
        parts = (f"{detail['split_detail']['shards']} target splits"
                 if "split_detail" in detail else
                 f"{detail['profile_detail']['slices']} profile slices")
        print(f"[split] small, {parts}: equal to {name}")
    print(f"[split] small: {time.perf_counter() - t0:.1f} s")

    fx = json.loads((fixtures / "torch_port_real.json").read_text())
    fa = synth.write_genome_set(work / "split_real", "real")
    rdb = create_setdb([str(p) for p in fa], str(work / "split_real_db"))
    n_split = len(splits_for_memory_budget(rdb.lengths, SPLIT_BUDGET_REAL))
    if not 3 <= n_split <= 4:
        fail(f"split: {SPLIT_BUDGET_REAL} bytes make {n_split} splits of the "
             f"real set, not 3-4")
    sw_cuda.reset_counts()
    t0 = time.perf_counter()
    res = cluster_search_to_file(
        rdb, rdb, str(work / "split_real.tsv"),
        params=ClusterSearchParams(filter_self_match=True,
                                   split_memory_limit=SPLIT_BUDGET_REAL),
        device=dev)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = read_counts()
    if launches["fwd"] <= 0 or launches["rev"] <= 0:
        fail(f"split: the real run did not launch both kernels: {launches}")
    got = (*counts(res.tsv), canonical_sha256(res.tsv))
    want = (fx["hits"], fx["clusters"], fx["canonical_sha256"])
    if got != want:
        fail(f"split: the real set in {n_split} splits differs from the "
             f"unsplit fixture: {got} vs {want}")
    tm = res.timings
    sd = tm["split_detail"]
    ad = tm["align_detail"]
    print(f"[split] real, {SPLIT_BUDGET_REAL} bytes: {n_split} target splits; "
          f"clustersearch {t_search:.2f} s = prefilter {tm['prefilter']:.2f} "
          f"(shards {', '.join(f'{x:.2f}' for x in sd['shard_s'])}; merge "
          f"{sd['merge_s']:.3f}) + align {tm['align']:.2f} + aggregate "
          f"{tm['aggregate']:.2f}; {ad['fwd_pairs']} + {ad['rev_pairs']} "
          f"pairs, kernel {ad['fwd_kernel_ms']:.2f} + "
          f"{ad['rev_kernel_ms']:.2f} ms; launches {launches}; {got[0]} hits "
          f"/ {got[1]} clusters, equal to the unsplit fixture")
    return launches


# -------------------------------------- 16-20. the sharded and GFF paths
SHARDS = 4              # target shards of the sharded phase (B8)
B8_REPLACES = "spacedust_tpu/parallel/sw_sharded.py:40"


def real_setdb(work: Path, tag: str):
    """The real-size set of torch_port_real.json through createsetdb
    under work/tag; returns (fixture, SetDB, its directory)."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    fx = json.loads((ROOT / "tests" / "fixtures"
                     / "torch_port_real.json").read_text())
    size = next((k for k, v in synth.SIZES.items()
                 if list(v) == fx["sizes"]), None)
    if size is None or fx["seed"] != synth.SEED:
        fail("tests/fixtures/torch_port_real.json does not match synth.py")
    fa = synth.write_genome_set(work / tag, size)
    path = work / f"{tag}_db"
    return fx, create_setdb([str(p) for p in fa], str(path)), path


def equal_to_real(tag: str, tsv: str, fx: dict) -> None:
    from spacedust_tpu_torch.cluster.summarize import canonical_sha256
    got = (*counts(tsv), canonical_sha256(tsv))
    want = (fx["hits"], fx["clusters"], fx["canonical_sha256"])
    if got != want:
        fail(f"{tag}: the real set differs from torch_port_real.json: "
             f"{got} vs {want}")


@contextlib.contextmanager
def recording_flushes(stages: dict):
    """Record, per direction, the largest stage a ShardedAlignDB
    dispatched: the engine and its buffered jobs (global offsets)."""
    from spacedust_tpu_torch.parallel import sw_sharded
    orig = sw_sharded.ShardedAlignDB.flush

    def flush(self, go, ge, reverse):
        buf = self._buf.get((go, ge, reverse), [])
        n = sum(len(b[0]) for b in buf)
        d = "rev" if reverse else "fwd"
        if n and (d not in stages or n > stages[d][-1]):
            stages[d] = (self, [tuple(np.array(c) for c in b) for b in buf],
                         go, ge, n)
        return orig(self, go, ge, reverse)

    sw_sharded.ShardedAlignDB.flush = flush
    try:
        yield
    finally:
        sw_sharded.ShardedAlignDB.flush = orig


def shard_edge_grid(db, shards, rng, per_shard: int = 48) -> np.ndarray:
    """(5, D, B) forward grid: in every shard its first and last target
    (the reverse pass reads a target backwards from its end point) and
    random others, against random queries; shard-local target offsets."""
    toffs = db.offsets
    grid = np.zeros((5, len(shards), per_shard), dtype=np.int64)
    for d, (s, e) in enumerate(shards):
        tk = np.concatenate([[s, e - 1, s, e - 1],
                             rng.integers(s, e, per_shard - 4)])
        qk = rng.integers(0, db.size, per_shard)
        qk[:2] = tk[:2]                      # each end target against itself
        grid[0, d], grid[1, d] = db.offsets[qk], db.lengths[qk]
        grid[2, d] = toffs[tk] - toffs[s]
        grid[3, d] = db.lengths[tk]
    grid[4] = -1
    return grid


def check_shard_grid(sdb, db, shards, errs: dict) -> int:
    """The edge grid through the stream that the main path runs
    (ShardedAlignDB.enqueue / flush / collect, global target offsets, all
    shards' jobs in one stage under shuffled positions), forward and then
    reverse from the forward end points, each shard's results against the
    plain version over that shard's own resident tensors.  Then the same
    without the first shard's jobs, so that the shard on whose card's
    stream the stage is timed gets none.  Returns the pairs a shard."""
    rng = np.random.default_rng(SEED)
    grid = shard_edge_grid(db, shards, rng)
    n_sh, per = grid.shape[1:]
    err = 0
    for first in (0, 1):
        glob = grid[:, first:].copy()
        glob[2] += sdb.tok_starts[first:, None]
        fcols = [c.reshape(-1) for c in glob]
        pos = rng.permutation(len(fcols[0]))

        def run(cols, reverse):
            got = np.zeros((6, len(pos)), np.int64)
            for p, c in sdb.collect(sdb.enqueue([(*cols, pos)], GO, GE,
                                                reverse)
                                    + sdb.flush(GO, GE, reverse)):
                got[:, p] = np.stack(c)
            return got[:, pos]                # back in job order

        fwd = run(fcols, False)
        rcols = [fcols[0], fwd[2] + 1, fcols[2], fwd[1] + 1, fwd[0]]
        rev = run(rcols, True)
        if not rev[3].all():
            fail("sharded: a reverse job of the edge grid missed its "
                 "terminate score")
        for d in range(first, n_sh):
            sl = slice((d - first) * per, (d - first + 1) * per)
            for name, cols, got in (("fwd", fcols, fwd),
                                    ("rev", rcols, rev)):
                local = np.stack([c[sl] for c in cols])
                local[2] -= sdb.tok_starts[d]
                ref = plain(name)(*sdb.shards[d]._resident(),
                                  np.ascontiguousarray(local), GO, GE)
                ref = ref.cpu().numpy()
                e = int(np.abs(got[:, sl] - ref).max())
                if e > TOL or not np.array_equal(got[:, sl], ref):
                    fail(f"sharded: shard {d} {name} on the edge grid "
                         f"differs from the plain version (max abs err "
                         f"{e})")
                err = max(err, e)
    errs["sharded"] = max(errs.get("sharded", 0), err)
    return per


def time_sharded_stage(d: str, stage: tuple, card: str) -> dict:
    """The largest sharded stage of direction d again, on the engine that
    ran it: wall ms on the card (the events round the stage, from before
    the first shard's launch to the end of the last shard's work, 3 runs
    after a warm one) against the plain version shard by shard (host
    clock), outputs equal, beside the bound of its cells."""
    sdb, buf, go, ge, n = stage
    reverse = d == "rev"

    def run():
        return sdb.collect(sdb.enqueue(buf, go, ge, reverse)
                           + sdb.flush(go, ge, reverse))

    def by_pos(collected):
        out = np.zeros((6, n), np.int64)
        for pos, cols in collected:
            out[:, pos] = np.stack(cols)
        return out

    got = by_pos(run())
    w0 = sdb._stages["stage_wall_ms"]
    for _ in range(3):
        run()
    wall = (sdb._stages["stage_wall_ms"] - w0) / 3
    cols = [np.concatenate([b[i] for b in buf]).astype(np.int64)
            for i in range(6)]
    shard = np.searchsorted(sdb.tok_starts, cols[2], side="right") - 1
    ref = np.zeros((6, n), np.int64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s, db_s in enumerate(sdb.shards):
        sel = np.nonzero(shard == s)[0]
        js = np.stack([c[sel] for c in cols[:5]])
        js[2] -= sdb.tok_starts[s]
        ref[:, cols[5][sel]] = plain(d)(*db_s._resident(),
                                        np.ascontiguousarray(js), go,
                                        ge).cpu().numpy()
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    err = int(np.abs(got - ref).max())
    if err > TOL:
        fail(f"sharded {d} stage: kernels != plain (max abs err {err})")
    js = np.stack(cols[:5])
    b_ms, b_by = bound_ms(d, js)
    per = [int((shard == s).sum()) for s in range(sdb.n_shards)]
    print(f"[sharded] {d} stage of the main path, {n} pairs over "
          f"{sdb.n_shards} shards ({per}), {cells(js) / 1e9:.3f} G cells: "
          f"wall on the card {wall:.2f} ms; plain shard by shard "
          f"{p_ms:.2f} ms; bound {b_ms:.2f} ms by {b_by}; equal; {card}")
    name = KERNELS[d][0]
    return {"name": f"{name} over {sdb.n_shards} target shards (B8)",
            "route": "cuda",
            "source": "spacedust_tpu_torch/parallel/sw_sharded.py",
            "kernel_source": "spacedust_tpu_torch/csrc/sw.cu",
            "replaces": B8_REPLACES,
            "launches": None, "max_abs_err": err, "ms": wall,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "share_of_bound": b_ms / wall,
            "pairs": n, "pairs_per_shard": per, "cells": cells(js)}


def sharded_phase(work: Path, dev: torch.device, errs: dict,
                  card: str) -> tuple[dict, list]:
    """The real set over SHARDS target shards on the card: the concurrent
    split prefilter against the single index (as sets a query), the
    sharded clustersearch (counters reset just before and read just
    after; every shard must launch) against torch_port_real.json, each
    shard's kernels against the plain version on an edge grid, and the
    largest sharded stage of each direction timed.  Returns the launch
    counts and the two B8 entries of the kernels line."""
    from spacedust_tpu_torch.native import comp_bias_batch
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.parallel import pipeline
    from spacedust_tpu_torch.parallel.split import residue_balanced_splits
    from spacedust_tpu_torch.parallel.sw_sharded import (ShardedAlignDB,
                                                         make_mesh)
    from spacedust_tpu_torch.search.prefilter import PrefilterEngine
    from spacedust_tpu_torch.stats.submat import load_substitution_matrix
    from spacedust_tpu_torch.workflow.clustersearch import ClusterSearchParams
    fx, db, _path = real_setdb(work, "sharded_real")
    shards = residue_balanced_splits(db.lengths, SHARDS)
    kw = dict(cov_thr=0.8, cov_mode=2, same_qt_db=True)
    t0 = time.perf_counter()
    single = PrefilterEngine(db, db, **kw).match_all()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    split = pipeline.sharded_prefilter(db, db, shards, **kw)
    t_split = time.perf_counter() - t0
    st = pipeline.sharded_prefilter.last_stats
    n_order = 0
    for qk in range(db.size):
        a = [(h.seq_id, h.score, h.diagonal) for h in single.get(qk, [])]
        b = [(h.seq_id, h.score, h.diagonal) for h in split.get(qk, [])]
        if sorted(a) != sorted(b):
            fail(f"sharded: the split prefilter's hits of query {qk} "
                 f"differ from the single index's")
        n_order += a != b
    index = ", ".join(f"{x:.2f}" for x in st["index_s"])
    print(f"[sharded] prefilter over {SHARDS} shards: hits equal to the "
          f"single index's for all {db.size} queries ({n_order} lists in "
          f"another order of ties); single {t_single:.2f} s, split "
          f"{t_split:.2f} s = index {index} (side by side) + bitmap OR "
          f"{st['bitmap_or_s']:.3f} + beam "
          f"{st['beam_s']:.2f} + probes "
          f"{', '.join(f'{x:.2f}' for x in st['probe_s'])} + merge "
          f"{st['merge_s']:.3f}")

    stages: dict = {}
    with recording_flushes(stages):
        sw_cuda.reset_counts()
        t0 = time.perf_counter()
        res = pipeline.sharded_cluster_search(
            db, db, ClusterSearchParams(filter_self_match=True),
            n_shards=SHARDS, device=dev)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = read_counts()
    equal_to_real("sharded", res.tsv, fx)
    det = res.timings["search_detail"]
    ad = det["align_detail"]
    for d in ("fwd", "rev"):
        if min(ad[f"shard_{d}_launches"]) <= 0:
            fail(f"sharded: a shard launched no {d} kernel: "
                 f"{ad[f'shard_{d}_launches']}")
    print(f"[sharded] real over {SHARDS} shards on {dev}: clustersearch "
          f"{t_search:.2f} s = search {res.timings['search']:.2f} "
          f"(prefilter {det['prefilter_s']:.2f}, align {det['align_s']:.2f}) "
          f"+ aggregate {res.timings['aggregate']:.2f}; launches {launches}; "
          f"{ad['stages']} stages, wall on the card {ad['stage_wall_ms']:.2f} "
          f"ms; per shard: fwd launches {ad['shard_fwd_launches']}, pairs "
          f"{ad['shard_fwd_pairs']}, kernel ms "
          f"{[round(x, 2) for x in ad['shard_fwd_kernel_ms']]}; rev launches "
          f"{ad['shard_rev_launches']}, pairs {ad['shard_rev_pairs']}, kernel "
          f"ms {[round(x, 2) for x in ad['shard_rev_kernel_ms']]}; equal to "
          f"torch_port_real.json; {card}")
    print(f"[sharded] align detail {json.dumps(ad)}")

    mat = load_substitution_matrix()
    qbias = comp_bias_batch(
        np.ascontiguousarray(db.seq_data, dtype=np.uint8),
        np.ascontiguousarray(db.offsets[:-1], dtype=np.int64),
        np.ascontiguousarray(db.lengths, dtype=np.int32),
        np.ascontiguousarray(mat.sub_int, dtype=np.int32),
        np.ascontiguousarray(mat.p_back, dtype=np.float64))
    toffs = db.offsets
    sdb = ShardedAlignDB(make_mesh(SHARDS, dev), db.seq_data, qbias,
                         db.seq_data, [(int(toffs[s]), int(toffs[e]))
                                       for s, e in shards], mat.sub_int)
    n = check_shard_grid(sdb, db, shards, errs)
    print(f"[sharded] edge grid through enqueue / flush / collect: {n} "
          f"pairs a shard (its first and last target among them), forward "
          f"and reverse, and again without shard 0's pairs; every shard "
          f"equal to the plain version")
    report = [time_sharded_stage(d, stages[d], card) for d in ("fwd", "rev")]
    for entry, d in zip(report, ("fwd", "rev")):
        entry["launches"] = launches[d]
        entry["max_abs_err"] = max(entry["max_abs_err"], errs["sharded"])
        entry["shard_launches"] = ad[f"shard_{d}_launches"]
        entry["stage_wall_ms_main_path"] = ad["stage_wall_ms"]
    return launches, report


def multihost_phase(work: Path) -> dict:
    """clustersearch of the real set as 2 worker processes of 2 target
    shards each, all on the card (parallel/multihost.py::run_multihost):
    equal to torch_port_real.json; each worker must launch K1 and K2.
    Returns the workers' launch counts summed."""
    from spacedust_tpu_torch.parallel.multihost import run_multihost
    from spacedust_tpu_torch.workflow.clustersearch import ClusterSearchParams
    fx, _db, path = real_setdb(work, "mh_real")
    out, tmp = work / "mh_real.tsv", work / "mh_real_tmp"
    t0 = time.perf_counter()
    run_multihost(str(path), str(out), 2,
                  ClusterSearchParams(filter_self_match=True),
                  tmp_dir=str(tmp), local_devices=2, device="cuda")
    t_run = time.perf_counter() - t0
    equal_to_real("multihost", out.read_text(), fx)
    total = dict.fromkeys(KERNELS, 0)
    for r in range(2):
        m = json.loads((tmp / f"metrics.{r}.json").read_text())
        lc = {d: m["launches"][KERNELS[d][2]] for d in KERNELS}
        if lc["fwd"] <= 0 or lc["rev"] <= 0:
            fail(f"multihost: rank {r} did not launch K1 and K2: {lc}")
        for d in KERNELS:
            total[d] += lc[d]
        ad = m["align_detail"]
        print(f"[multihost] rank {r}: search {m['search_s']:.2f} s; "
              f"launches {lc}; shard fwd launches "
              f"{ad['shard_fwd_launches']}, rev {ad['shard_rev_launches']}; "
              f"stage wall {ad['stage_wall_ms']:.2f} ms")
    print(f"[multihost] real, 2 processes x 2 shards on one card: "
          f"{t_run:.2f} s from launch to rank 0's TSV; equal to "
          f"torch_port_real.json")
    return total


def gff_phase(work: Path, dev: torch.device) -> dict:
    """Contigs plus GFF3 (synth.py --gff): small through createsetdb
    --gff-dir and clustersearch on the card, equal to
    torch_port_small_gff.tsv byte for byte; the real set's ingest equal
    to torch_port_real_gff.json's digest, and its clustersearch on the
    card (counters reset just before and read just after) held to the
    self-hit invariant.  Returns the launch counts of that run."""
    from spacedust_tpu_torch import synth
    from spacedust_tpu_torch.db.gff import ingest_digest
    from spacedust_tpu_torch.ops import sw_cuda
    from spacedust_tpu_torch.workflow.clustersearch import (
        ClusterSearchParams, cluster_search_to_file)
    from spacedust_tpu_torch.workflow.createsetdb import create_setdb
    fixtures = ROOT / "tests" / "fixtures"
    t0 = time.perf_counter()
    fnas, _gffs = synth.write_gff_set(work / "gff_small", "small")
    db, out = str(work / "gff_small_db"), work / "gff_small.tsv"
    run_cli(["createsetdb", *map(str, fnas), db, "--gff-dir",
             str(work / "gff_small" / "gffs.tsv")], quiet=True)
    run_cli(["clustersearch", db, db, str(out), "--filter-self-match",
             "--device", "cuda"], quiet=True)
    if out.read_bytes() != (fixtures / "torch_port_small_gff.tsv"
                            ).read_bytes():
        fail("gff: small differs from torch_port_small_gff.tsv")
    print(f"[gff] small: createsetdb --gff-dir + clustersearch equal to "
          f"torch_port_small_gff.tsv ({time.perf_counter() - t0:.1f} s)")
    fx = json.loads((fixtures / "torch_port_real_gff.json").read_text())
    size = next(k for k, v in synth.SIZES.items() if list(v) == fx["sizes"])
    t0 = time.perf_counter()
    fnas, _gffs = synth.write_gff_set(work / "gff_real", size)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    rdb = create_setdb([str(p) for p in fnas], str(work / "gff_real_db"),
                       gff_dir=str(work / "gff_real" / "gffs.tsv"))
    t_ingest = time.perf_counter() - t0
    got = ingest_digest(rdb)
    if got != {k: fx[k] for k in ("genes", "residues", "sha256")}:
        fail(f"gff: the real ingest's digest {got} differs from "
             f"torch_port_real_gff.json")
    tmp = work / "gff_real_tmp"
    sw_cuda.reset_counts()
    t0 = time.perf_counter()
    res = cluster_search_to_file(
        rdb, rdb, str(work / "gff_real.tsv"), str(tmp),
        params=ClusterSearchParams(filter_self_match=True), device=dev)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = read_counts()
    if launches["fwd"] <= 0 or launches["rev"] <= 0:
        fail(f"gff: the real run did not launch K1 and K2: {launches}")
    n_self = self_hits_ok(rdb, tmp)
    hits, clusters = counts(res.tsv)
    print(f"[gff] real: {got['genes']} genes, {got['residues']} residues; "
          f"contigs + GFF3 written in {t_write:.2f} s, ingested in "
          f"{t_ingest:.2f} s, digest equal to torch_port_real_gff.json; "
          f"clustersearch {t_search:.2f} s, launches {launches}, {hits} hits "
          f"/ {clusters} clusters; {n_self} genes of >= 100 aa find "
          f"themselves with E < 1e-10")
    return launches


def nucl_phase(work: Path) -> None:
    """search --search-type 3 on the nucleotide contigs (synth.py --nucl),
    equal to torch_port_small_nucl.tsv byte for byte (host work)."""
    from spacedust_tpu_torch import synth
    q, t = synth.write_nucl_set(work / "nucl", "small")
    out = work / "nucl.tsv"
    t0 = time.perf_counter()
    run_cli(["search", str(q), str(t), str(out), "--search-type", "3"],
            quiet=True)
    if out.read_bytes() != (ROOT / "tests" / "fixtures"
                            / "torch_port_small_nucl.tsv").read_bytes():
        fail("nucl: search --search-type 3 differs from "
             "torch_port_small_nucl.tsv")
    print(f"[nucl] {len(out.read_text().splitlines())} alignments equal to "
          f"torch_port_small_nucl.tsv ({time.perf_counter() - t0:.2f} s)")


def entry_phase(errs: dict) -> None:
    """entry(): its one sw_forward launch against the plain version; and
    dryrun_multichip(SHARDS): the sharded and the 2-process clustersearch
    of the small set on the card, each equal to the single run."""
    from spacedust_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry("cuda")
    got = fn(*args)
    errs["fwd"] = max(errs["fwd"], compare("entry", got,
                                           plain("fwd")(*args)))
    t0 = time.perf_counter()
    dryrun_multichip(SHARDS, device="cuda")
    print(f"[entry] entry(): {args[4].shape[1]} pairs, equal to the plain "
          f"version; dryrun_multichip({SHARDS}) passed "
          f"({time.perf_counter() - t0:.1f} s)")


def bound_ms(d: str, js: np.ndarray) -> tuple[float, str]:
    """The least milliseconds the card could take for stage js of
    direction d, and what sets it.  Bytes: every token and bias byte of
    the stage's pairs read once (one byte a query residue and channel,
    one for its bias, one a target residue and channel; a profile query
    residue is its PROF_COLS-byte row), 40 bytes of job and 24 of result a
    pair.  Operations: CELL_INT32 instructions a cell."""
    channels = 2 if d.endswith("struct") else 1
    per_query = PROF_COLS if d.endswith("prof") else channels + 1
    nbytes = (int(js[1].sum()) * per_query + int(js[3].sum()) * channels
              + 64 * js.shape[1])
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * cells(js) * CELL_INT32[d] / INT32_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def event_ms(fn, reps: int = 3) -> float:
    """Milliseconds a call of fn by CUDA events, over reps calls after a
    warm one."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def launch_ms(fn, args: tuple, reps: int = 3) -> float:
    """Milliseconds of a wrapper's launches alone, by the events it
    records round them (after its job table is on the card), over reps
    calls after a warm one."""
    fn(*args)
    events: list = []
    for _ in range(reps):
        fn(*args, events=events)
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def stage_detail(d: str, args: tuple) -> None:
    """What sets a stage's time, and what the classes of query rows per
    lane buy: the stage's longest pair alone (on one warp: no other work
    can shorten that), the whole stage with every pair at 16 rows a lane,
    and the stage without its 32 longest pairs at the wrapper's own
    classes and forced into each compiled class, beside the lane-steps
    sum(ceil(qlen / 32 R) * (tlen + 31)) of that class, and the fit of
    the forced times to "a step costs R cells and an overhead"
    (sw_cuda.STEP_OVERHEAD_CELLS is taken from these fits).  The engine hands a stage over longest pair first."""
    from spacedust_tpu_torch.ops import sw_cuda
    *resident, jobs, go, ge = args
    reverse = d.startswith("rev")

    def ms(js, rows=None):
        plan = sw_cuda.warp_plan(js, sw_cuda.WARP_SCRATCH[reverse], rows=rows)
        return event_ms(lambda: sw_cuda._launch_warp(reverse, resident,
                                                     plan, go, ge))

    rest = jobs[:, 32:]
    print(f"[timing] {d} stage: longest pair ({int(jobs[1, 0])} x "
          f"{int(jobs[3, 0])}) alone {ms(jobs[:, :1]):.2f} ms; whole stage "
          f"at 16 rows a lane {ms(jobs, 16):.2f} ms; without its 32 longest "
          f"({rest.shape[1]} pairs, {cells(rest) / 1e9:.3f} G cells): own "
          f"classes {ms(rest):.2f} ms")
    per_step = []
    for rows in sw_cuda.LANE_ROWS:
        steps = int((-(-rest[1] // (32 * rows)) * (rest[3] + 31)).sum())
        t = ms(rest, rows)
        per_step.append(t / steps)
        print(f"[timing] {d} stage without its 32 longest, every pair at "
              f"{rows} rows a lane: {t:.2f} ms, {steps} lane-steps")
    slope, intercept = np.polyfit(sw_cuda.LANE_ROWS, per_step, 1)
    print(f"[timing] {d} stage: time a lane-step against rows a lane, "
          f"least squares: a step costs its rows and "
          f"{intercept / slope:.1f} cells")


def time_stages(stages: dict, launches: dict, errs: dict,
                card: str) -> list:
    """Kernel (launch_ms: the launches alone; event_ms: the wrapper's
    whole call) against the plain version (host clock, one call) on the
    main path's largest stages, and stage_detail of each.
    These launches come after the counts were read."""
    from spacedust_tpu_torch.ops import sw_cuda
    report = []
    print(f"[timing] bound: int32 rate {INT32_PER_S / 1e12:.2f} T "
          f"instructions/s (132 SMs x 64 lanes x 1.98 GHz), HBM "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; instructions a cell "
          f"{CELL_INT32}")
    for d, (name, replaces, _counter) in KERNELS.items():
        if d not in stages:
            continue
        args = stages[d]
        js = args[-3]
        fn = getattr(sw_cuda, name)
        got = fn(*args)
        w_ms = event_ms(lambda: fn(*args))
        k_ms = launch_ms(fn, args)
        t0 = time.perf_counter()
        ref = plain(d)(*args)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        errs[d] = max(errs[d], compare(f"main-path {d} stage", got, ref))
        c = cells(js)
        b_ms, b_by = bound_ms(d, js)
        print(f"[timing] {name}, main path's largest {d} stage: "
              f"{js.shape[1]} pairs, {c / 1e9:.3f} G cells; kernel "
              f"(launches alone) {k_ms:.2f} ms = {c / k_ms / 1e6:.2f} GCUPS; "
              f"wrapper (planning, job table copy, launches) {w_ms:.2f} ms; "
              f"plain "
              f"{p_ms:.2f} ms = {c / p_ms / 1e6:.3f} GCUPS; bound "
              f"{b_ms:.2f} ms by {b_by} ({b_ms / k_ms:.1%} of it "
              f"reached); equal; {card}")
        entry = {
            "name": name, "route": "cuda",
            "source": "spacedust_tpu_torch/csrc/sw.cu",
            "replaces": replaces, "launches": launches[d],
            "max_abs_err": errs[d], "ms": k_ms, "wrapper_ms": w_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a batched Smith-Waterman
            "library_ms": None, "share_of_bound": b_ms / k_ms,
            "pairs": int(js.shape[1]), "cells": c, "gcups": c / k_ms / 1e6,
            "plain_gcups": c / p_ms / 1e6}
        if not d.endswith("struct"):
            entry["also_replaces"] = GATHER
        stage_detail(d, args)
        report.append(entry)
    return report


def parse_phases(argv: list) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {', '.join(PHASES)} (default: all; "
                         "device and build always run)")
    names = [x for x in ap.parse_args(argv).phases.split(",") if x]
    unknown = [x for x in names if x not in PHASES]
    if unknown or not names:
        ap.error(f"unknown phases {unknown}; choose from {PHASES}")
    if "timing" in names and not ({"real", "struct-real", "profile-real"}
                                  & set(names)):
        ap.error("timing times the stages that real / struct-real / "
                 "profile-real dispatch")
    return tuple(x for x in PHASES if x in names)


def main(argv: list | None = None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
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

    # 2. build: g++ and nvcc side by side
    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        t_native = pool.submit(timed, native.build)
        t_nvcc = pool.submit(timed, sw_cuda.build, True)
        t_native, t_nvcc = t_native.result(), t_nvcc.result()
    print(f"[build] native (g++) {t_native:.2f} s, csrc/sw.cu (nvcc) "
          f"{t_nvcc:.2f} s, side by side {time.perf_counter() - t0:.2f} s")

    sub = torch.from_numpy(
        load_substitution_matrix().sub_int.astype(np.int8)).to(dev)
    errs = dict.fromkeys(KERNELS, 0)
    launches: dict = {}
    stages: dict = {}
    if "kernels" in phases:
        check_kernels(sub, errs)
    if "kernels-struct" in phases:
        check_kernels_struct(dev, errs)
    if "kernels-prof" in phases:
        check_kernels_prof(sub, errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "small" in phases:
            small_slice(Path(tmp))
        if "real" in phases:
            launches, stages = real_slice(Path(tmp), dev)
        if "struct-small" in phases:
            struct_small(Path(tmp))
        if "struct-real" in phases:
            s_launches, s_stages = struct_real(Path(tmp), dev)
            launches.update({d: s_launches[d]
                             for d in ("fwd_struct", "rev_struct")})
            stages.update(s_stages)
        if "toolkit" in phases:
            tk_launches = toolkit_phase(Path(tmp), sub, errs)
        if "profile-small" in phases:
            profile_small(Path(tmp))
        if "profile-real" in phases:
            p_launches, p_stages = profile_real(Path(tmp), dev)
            launches.update({d: p_launches[d]
                             for d in ("fwd_prof", "rev_prof")})
            stages.update(p_stages)
        if "iterative-small" in phases:
            iterative_small(Path(tmp))
        if "iterative-real" in phases:
            it_launches = iterative_real(Path(tmp))
        if "split" in phases:
            split_launches = split_phase(Path(tmp), dev)
        if "sharded" in phases:
            sh_launches, b8 = sharded_phase(Path(tmp), dev, errs, card)
        if "multihost" in phases:
            mh_launches = multihost_phase(Path(tmp))
        if "gff" in phases:
            gff_launches = gff_phase(Path(tmp), dev)
        if "nucl" in phases:
            nucl_phase(Path(tmp))
        if "entry" in phases:
            entry_phase(errs)
    report = (time_stages(stages, launches, errs, card)
              if "timing" in phases else [])
    torch.cuda.synchronize()
    if phases != PHASES:
        print(f"[partial] phases {','.join(phases)} passed; no result line "
              f"without the whole run")
        return 0
    if len(report) != len(KERNELS):
        fail(f"timed {len(report)} of {len(KERNELS)} kernels")
    for entry, d in zip(report, KERNELS):
        # the toolkit's own path: search --alt-ali at real size
        entry["launches_toolkit"] = tk_launches[d]
        if d in ("fwd", "rev") and tk_launches[d] <= 0:
            fail(f"the toolkit's search did not launch {entry['name']}")
        # the profile path: clusterdb and the profile search at real size
        entry["launches_profile"] = p_launches[d]
        # search --num-iterations 2 and the split clustersearch, real size
        entry["launches_iterative"] = it_launches[d]
        entry["launches_split"] = split_launches[d]
        # the sharded clustersearch (in this process and as 2 workers of
        # 2 shards) and the clustersearch over the GFF ingest, real size
        entry["launches_sharded"] = sh_launches[d]
        entry["launches_multihost"] = mh_launches[d]
        entry["launches_gff"] = gff_launches[d]
        for path, n in (("sharded", sh_launches), ("multihost", mh_launches),
                        ("gff", gff_launches)):
            if d in ("fwd", "rev") and n[d] <= 0:
                fail(f"the {path} path did not launch {entry['name']}")
    report += b8

    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
