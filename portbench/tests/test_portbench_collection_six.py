"""The `collection.six` cell: its files resolve by name, a small job of its
configuration (six genomes derived from 150 + 150 genes) is judged
correct and the `half` fault fails it, and the readers of the clustering
tail's spans and counts (clusterhits_hits_s, clusterhits_merge_s,
merge_ns_per_cell) on hand-made recordings of two jobs."""

import json
import sys
import types

import pytest

from conftest import ROOT, small_cell

CELL = "collection.six"
METRICS = ("clusterhits_hits_s", "clusterhits_merge_s", "merge_ns_per_cell")
EXACT = ("output_missing", "jobs_differ", "sw_wrong", "traceback_wrong",
         "hits_unbacked", "hits_not_best")


def test_cell_resolves_every_file(bench_json):
    from portbench import bench
    cell = bench.load_cell(ROOT, CELL)
    pair = bench.load_cell(ROOT, "seq.regression")
    assert cell.chips == 1 and cell.kind == "seq"
    assert cell.config["name"] == "seq-collection-6"
    assert cell.config["genomes"] == 6
    assert cell.config["reduced"] == ["genomes"]
    assert any("12" in a and "6" in a for a in cell.config["assumed"])
    for key in ("genes", "flags", "gap_open", "gap_extend", "guarantees"):
        assert cell.config[key] == pair.config[key], key
    assert cell.traffic == pair.traffic
    assert cell.spec == pair.spec
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    assert {m["name"] for m in cell.end_to_end} == {"job_s",
                                                    "host_peak_gib",
                                                    "setup_s"}
    for name in METRICS:
        assert callable(bench.load_metric(name).read)
    (entry,) = [c for c in bench_json["configs"]
                if c["name"] == "seq-collection-6"]
    assert json.loads((ROOT / entry["file"]).read_text())["reduced"] \
        == entry["reduced"]


def _cell():
    return small_cell(CELL)


def test_small_job_is_correct_and_read(local_cache):
    """A traced job on six genomes: correct, every exact number 0, and the
    tail's three metrics read from the program's spans and counts."""
    from portbench import bench
    out = bench.run_cell(_cell(), 2**31 + 19, 0.01, True, device="cpu")
    assert out["correct"], out["checks"]
    for name in EXACT:
        assert out["checks"][name]["value"] == 0, name
    for name in METRICS:
        assert out["metrics"][name]["value"] > 0, name


def test_half_fault_fails_it(local_cache):
    from portbench import bench, faults
    with faults.planted("half"):
        out = bench.run_cell(_cell(), 2**31 + 19, 0.01, False, device="cpu")
    assert out["correct"] is False
    assert out["checks"]["pairs_missed"]["value"] > 0.3


MS = 1_000_000                       # ns


def _span(name, t0_ms, t1_ms, **attrs):
    return (name, 1, t0_ms * MS, t1_ms * MS, attrs, 0)


def _count(name, t_ms, n):
    return (name, 1, t_ms * MS, n)


# two jobs, each from its createsetdb.read: the first merges two genome
# pairs (K 3 and 2: 13 cells), the second one (K 4: 16 cells) and builds
# a third pair's single hit
SPANS = [
    _span("createsetdb.read", 0, 10),
    _span("cluster.clusterhits", 50, 90),
    _span("cluster.clusterhits.hits", 51, 53, qset=0, tset=1, hits=3),
    _span("cluster.clusterhits.merge", 53, 60, qset=0, tset=1, hits=3),
    _span("cluster.clusterhits.hits", 60, 61, qset=1, tset=0, hits=2),
    _span("cluster.clusterhits.merge", 61, 67, qset=1, tset=0, hits=2),
    _span("createsetdb.read", 200, 210),
    _span("cluster.clusterhits", 250, 280),
    _span("cluster.clusterhits.hits", 251, 255, qset=0, tset=1, hits=4),
    _span("cluster.clusterhits.merge", 255, 263, qset=0, tset=1, hits=4),
    _span("cluster.clusterhits.hits", 263, 264, qset=1, tset=0, hits=1),
]
COUNTS = [
    _count("clusterhits_pairs", 90, 2), _count("clusterhits_hits", 90, 5),
    _count("clusterhits_cells", 90, 13),
    _count("clusterhits_pairs", 280, 1), _count("clusterhits_hits", 280, 5),
    _count("clusterhits_cells", 280, 16),
]
READINGS = {
    "clusterhits_hits_s": (0.003 + 0.005) / 2,
    "clusterhits_merge_s": (0.013 + 0.008) / 2,
    "merge_ns_per_cell": (13 * MS / 13 + 8 * MS / 16) / 2,
}


class _Ctx:
    def __init__(self, n_jobs, traced=True):
        self.jobs = [{}] * n_jobs
        self.trace = {"busy_s": 0.0} if traced else None


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in for the program's recorder, holding SPANS and COUNTS."""
    from portbench import spans
    fake = types.SimpleNamespace(snapshot=lambda: types.SimpleNamespace(
        spans=list(SPANS), counts=list(COUNTS)))
    monkeypatch.setitem(sys.modules, spans.RECORDER, fake)
    return fake


@pytest.mark.parametrize("name", METRICS)
def test_reader_sums_two_jobs(recorder, name):
    from portbench import bench
    assert bench.load_metric(name).read(_Ctx(2)) == pytest.approx(
        READINGS[name])


def test_merge_reader_takes_the_last_jobs(recorder):
    """With one job in the window, the earlier job's spans and counts are
    left out."""
    from portbench import bench
    got = bench.load_metric("merge_ns_per_cell").read(_Ctx(1))
    assert got == pytest.approx(8 * MS / 16)


@pytest.mark.parametrize("name", METRICS)
def test_reader_finds_nothing(monkeypatch, recorder, name):
    """Nothing to read untraced, from a program without the recorder, or
    from one whose tail records no such span or count (the parent of the
    change that added them)."""
    from portbench import bench, spans
    reader = bench.load_metric(name)
    assert reader.read(_Ctx(2, traced=False)) is None
    monkeypatch.setitem(sys.modules, spans.RECORDER, types.SimpleNamespace(
        snapshot=lambda: types.SimpleNamespace(spans=[
            s for s in SPANS if not s[0].startswith("cluster.clusterhits.")],
            counts=[])))
    assert reader.read(_Ctx(2)) is None
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert reader.read(_Ctx(2)) is None
