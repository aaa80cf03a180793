"""The clustering tail on a small seeded collection of four genomes (SW on
the CPU, plain version): the port's cluster TSV against the JAX
package's, line for line; one `cluster.clusterhits.hits` span a genome
pair's match and one `cluster.clusterhits.merge` span a match of two hits
or more, inside `cluster.clusterhits`; the tail's counts against sums
over its input; the same clusters and TSV with recording on and off; the
native merge against the Python loop on every match of the collection."""

import dataclasses

import numpy as np
import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.workflow.clustersearch import ClusterSearchParams as JaxCSP
from spacedust_tpu.workflow.clustersearch import cluster_search as jax_search
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.cluster.aggregate import besthit_by_set
from spacedust_tpu_torch.cluster.clusterhits import cluster_hits
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.utils import trace
from spacedust_tpu_torch.workflow.clustersearch import (ClusterSearchParams,
                                                        cluster_search)

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

GENOMES = 4
SEED = 19


def _collection(out_dir, n: int = GENOMES, seed: int = SEED) -> list:
    """n genomes derived from the small pair (150 + 150 genes, each cut to
    120 aa), alternately from A and from B, as tools/make_scale_db.py
    derives its set: a gene kept with probability 0.9, operon-scale
    blocks of 5-20 genes, a quarter of them moved elsewhere and 40 % of
    those inverted (order and strands), every residue substituted with
    probability 0.12."""
    pair = synth.make_genomes(synth.SIZES["small"], seed)
    rng = np.random.default_rng([seed, 1])
    paths = []
    for d in range(n):
        src = [[prot[:120], strand] for prot, strand in pair[d % 2]]
        kept = [i for i in range(len(src)) if rng.random() < 0.9]
        blocks, i = [], 0
        while i < len(kept):
            w = int(rng.integers(5, 21))
            blocks.append(kept[i:i + w])
            i += w
        order = list(range(len(blocks)))
        inverted = set()
        for b in rng.permutation(len(blocks))[:len(blocks) // 4].tolist():
            order.remove(b)
            order.insert(int(rng.integers(0, len(order) + 1)), b)
            if rng.random() < 0.4:
                inverted.add(b)
        genes = []
        for b in order:
            flip = b in inverted
            for i in (blocks[b][::-1] if flip else blocks[b]):
                prot, strand = src[i]
                prot = prot.copy()
                sub = rng.random(len(prot)) < 0.12
                prot[sub] = rng.integers(0, 20, int(sub.sum()))
                genes.append([prot, -strand if flip else strand])
        tag = "abcdefgh"[d]
        p = out_dir / f"genome_{tag}.faa"
        synth.write_fasta(p, f"SYN{tag.upper()}_000001.1", genes)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's search with recording off, then on; the JAX package's."""
    fastas = _collection(tmp_path_factory.mktemp("collection"))
    db = create_setdb_from_fastas(fastas)
    par = ClusterSearchParams(filter_self_match=True)
    trace.take()                      # whatever an earlier test left
    off = cluster_search(db, db, par, device="cpu")
    trace.start()
    try:
        on = cluster_search(db, db, par, device="cpu")
    finally:
        rec = trace.stop()
    jdb = jax_fastas(fastas)
    ref = jax_search(jdb, jdb, JaxCSP(filter_self_match=True))
    return db, off, on, rec, ref


def _named(rec, name: str) -> list:
    return [s for s in rec.spans if s[0] == name]


def _counts(rec) -> dict:
    out: dict = {}
    for name, _tid, _t, n in rec.counts:
        out[name] = out.get(name, 0) + n
    return out


def test_collection_tsv_matches_jax(runs):
    db, off, _on, _rec, ref = runs
    assert db.num_sets == GENOMES
    assert off.tsv.splitlines() == ref.tsv.splitlines()
    assert ([dataclasses.astuple(m) for m in off.matches]
            == [dataclasses.astuple(m) for m in ref.matches])
    # every ordered pair of genomes has its match, most of them clusters
    assert {(m.qset, m.tset) for m in off.matches} == {
        (a, b) for a in range(GENOMES) for b in range(GENOMES) if a != b}
    assert len({(c.qset, c.tset) for c in off.clusters}) >= 6
    assert max(len(m.lines) for m in off.matches) >= 50


def test_one_span_a_match(runs):
    _db, _off, on, rec, _ref = runs
    want = [{"qset": m.qset, "tset": m.tset, "hits": len(m.lines)}
            for m in on.matches]
    assert [s[4] for s in _named(rec, "cluster.clusterhits.hits")] == want
    assert ([s[4] for s in _named(rec, "cluster.clusterhits.merge")]
            == [a for a in want if a["hits"] >= 2])
    (outer,) = _named(rec, "cluster.clusterhits")
    for name in ("cluster.clusterhits.hits", "cluster.clusterhits.merge"):
        for s in _named(rec, name):
            assert outer[2] <= s[2] <= s[3] <= outer[3]
            assert s[1] == outer[1]


def test_counts_are_sums_over_the_input(runs):
    _db, _off, on, rec, _ref = runs
    ks = [len(m.lines) for m in on.matches]
    counts = _counts(rec)
    assert counts["clusterhits_hits"] == sum(ks)
    assert counts["clusterhits_cells"] == sum(k * k for k in ks if k >= 2)
    assert counts["clusterhits_pairs"] == sum(1 for k in ks if k >= 2)
    assert counts["combine_set_pairs"] == len(on.matches)
    # each match line is the best hit of one (query gene, target set)
    assert counts["besthit_groups"] >= sum(ks)


def test_besthit_counts_its_groups(runs):
    """Three query genes' records over two, one and three target sets."""
    db = runs[0]
    first = [int(np.nonzero(db.set_ids == s)[0][0]) for s in range(GENOMES)]

    def rec(q, t, ev):
        return [str(q), str(t), "0", "0.9", ev] + ["1"] * 7

    results = {first[0]: [rec(first[0], first[1], "1e-9"),
                          rec(first[0], first[1] + 1, "1e-5"),
                          rec(first[0], first[2], "1e-3")],
               first[1]: [rec(first[1], first[0], "1e-9")],
               first[2]: [rec(first[2], t, "1e-4") for t in first[1:]]}
    trace.start()
    try:
        agg = besthit_by_set(results, db)
    finally:
        got = _counts(trace.stop())
    assert got == {"besthit_groups": 6}
    assert sum(len(v) for v in agg.values()) == 6


@pytest.mark.parametrize("use_native", [True, False])
def test_recording_changes_no_clusters(runs, use_native):
    db, off, on, _rec, _ref = runs
    assert on.tsv == off.tsv
    # the Python loop on the smaller matches (it runs K^2 scores in Python)
    matches = (on.matches if use_native
               else [m for m in on.matches if len(m.lines) <= 40])
    assert any(len(m.lines) >= 2 for m in matches)

    def clusters():
        return [(c.header, [h.line for h in c.hits])
                for c in cluster_hits(matches, db, db,
                                      use_native=use_native)]

    trace.take()
    plain = clusters()
    trace.start()
    try:
        recorded = clusters()
    finally:
        rec = trace.stop()
    assert recorded == plain
    assert len(_named(rec, "cluster.clusterhits.merge")) == sum(
        1 for m in matches if len(m.lines) >= 2)


def test_native_merge_matches_python_loop(runs):
    """Every genome pair's match, K up to ~130 hits: the native engine's
    clusters are the executable specification's."""
    db, _off, on, _rec, _ref = runs

    def clusters(use_native):
        return [(c.header, [h.line for h in c.hits])
                for c in cluster_hits(on.matches, db, db,
                                      use_native=use_native)]

    native = clusters(True)
    assert len(native) >= 20
    assert native == clusters(False)
