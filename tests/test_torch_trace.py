"""The port's span recorder (utils/trace.py) and its spans in a small
clustersearch through cli.main (SW on the CPU, plain version): with
recording off nothing is recorded and the `detail:` line keeps the keys
that the benchmark reads; with it on, every stage's span, nested as the
stages run, the prefilter's matcher on its own thread, one match and one
wait a query chunk, the detail's stage times equal to their spans; the
recorder's clock against torch.profiler's; the --trace-file export; the
structure search's and the target-sharded engine's spans."""

import contextlib
import io
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.utils import trace

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

CHUNKS = [0, 256]          # 300 queries: the stream's two prefilter chunks

# each span of the sequence search and the one it runs inside, on the
# main thread
NESTED = [
    ("createsetdb.read", None), ("createsetdb.write", None),
    ("clustersearch", None),
    ("clustersearch.open_db", "clustersearch"),
    ("prefilter.index_build", "clustersearch"),
    ("prefilter.index_mask", "prefilter.index_build"),
    ("prefilter.index_postings", "prefilter.index_build"),
    ("prefilter.index_hash", "prefilter.index_build"),
    ("prefilter.index_save", "prefilter.index_build"),
    ("align", "clustersearch"),
    ("align.setup", "align"),
    ("prefilter.wait", "align"),
    ("align.enqueue", "align"),
    ("align.finish", "align"),
    ("sw.dispatch", "align"),
    ("sw.fetch", "align.finish"),
    ("align.survivors", "align.finish"),
    ("align.reverse", "align.finish"),
    ("align.traceback", "align.finish"),
    ("align.records", "align.finish"),
    ("cluster", "clustersearch"),
    ("cluster.format", "cluster"),
    ("cluster.checkpoint", "cluster"),
    ("cluster.besthit", "cluster"),
    ("cluster.merge", "cluster"),
    ("cluster.combine", "cluster"),
    ("cluster.clusterhits", "cluster"),
    ("cluster.clusterhits.hits", "cluster.clusterhits"),
    ("cluster.clusterhits.merge", "cluster.clusterhits"),
    ("cluster.summarize", "cluster"),
    ("clustersearch.write_tsv", "clustersearch"),
    ("clustersearch.seq_to_clu", "clustersearch"),
]


def _genomes(d: Path) -> list[str]:
    """Two genomes of 150 genes, each gene cut to 120 aa, so that the
    plain SW takes a fraction of a second."""
    paths = []
    for tag, genes in zip("ab", synth.make_genomes((150, 150), 7)):
        p = d / f"genome_{tag}.faa"
        synth.write_fasta(p, f"SYN{tag.upper()}_000001.1",
                          [[prot[:120], strand] for prot, strand in genes])
        paths.append(str(p))
    return paths


def _run(argv: list[str]) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue()


def _detail(stdout: str) -> dict:
    return next(json.loads(ln.split("detail: ", 1)[1])
                for ln in stdout.splitlines() if "detail: " in ln)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One job with recording off, then one with it on, whose commands
    also write --trace-file."""
    d = tmp_path_factory.mktemp("trace")
    fastas = _genomes(d)
    out = {}
    for tag in ("off", "on"):
        run = d / tag
        run.mkdir()
        files = {c: run / f"{c}.json" for c in ("createsetdb",
                                                 "clustersearch")}
        extra = ({c: ["--trace-file", str(p)] for c, p in files.items()}
                 if tag == "on" else {c: [] for c in files})
        trace.take()                  # whatever an earlier test left
        if tag == "on":
            trace.start()
        _run(["createsetdb", *fastas, str(run / "db"),
              *extra["createsetdb"]])
        stdout = _run(["clustersearch", str(run / "db"), str(run / "db"),
                       str(run / "out.tsv"), str(run / "tmp"),
                       "--filter-self-match", "--device", "cpu",
                       *extra["clustersearch"]])
        rec = trace.stop() if tag == "on" else trace.take()
        out[tag] = (_detail(stdout), rec, files)
    return out


def _named(rec, name: str) -> list:
    return [s for s in rec.spans if s[0] == name]


def _main_tid(rec) -> int:
    return _named(rec, "clustersearch")[0][1]


def _within(inner, outer) -> bool:
    return outer[2] <= inner[2] and inner[3] <= outer[3]


# ------------------------------------------------------------------ off
def test_off_records_nothing(jobs):
    _detail_off, rec, _files = jobs["off"]
    assert not trace.recording()
    assert rec.spans == [] and rec.counts == []


@pytest.mark.parametrize("key", ["index", "prefilter", "align", "aggregate",
                                 "align_detail.fwd_kernel_ms",
                                 "align_detail.rev_kernel_ms",
                                 "align_detail.fwd_cells",
                                 "align_detail.rev_cells",
                                 "align_detail.n_batches",
                                 "align_detail.fwd_wrapper_ms"])
def test_detail_keeps_what_the_benchmark_reads(jobs, key):
    for tag in ("off", "on"):
        d = jobs[tag][0]
        for part in key.split("."):
            d = d[part]
        assert isinstance(d, (int, float)) and d >= 0


@pytest.mark.parametrize("key", ["aggregate_detail",
                                 "align_detail.dispatch_s",
                                 "align_detail.fetch_s"])
def test_detail_drops_the_spans_keys(jobs, key):
    d = jobs["off"][0]
    *path, last = key.split(".")
    for part in path:
        d = d[part]
    assert last not in d


# ------------------------------------------------------------------- on
@pytest.mark.parametrize("name,parent", NESTED)
def test_span_nests_where_its_stage_runs(jobs, name, parent):
    _d, rec, _f = jobs["on"]
    spans = _named(rec, name)
    assert spans, name
    main = _main_tid(rec)
    for s in spans:
        assert s[1] == main
        assert s[2] <= s[3] and s[5] > 0          # rss at the span's end
        if parent is not None:
            assert any(_within(s, p) for p in _named(rec, parent)), s


def test_matcher_runs_on_its_own_thread(jobs):
    _d, rec, _f = jobs["on"]
    main = _main_tid(rec)
    match = _named(rec, "prefilter.match")
    assert match and all(s[1] != main for s in match)
    assert all(s[1] == main for s in _named(rec, "prefilter.wait"))
    search = _named(rec, "clustersearch")[0]
    assert all(_within(s, search) for s in match)


# the target index's phases, and the attrs each carries
INDEX_PHASES = [("prefilter.index_mask", set()),
                ("prefilter.index_postings", {"postings", "threads"}),
                ("prefilter.index_hash", {"unique_kmers"})]


@pytest.mark.parametrize("name,attrs", INDEX_PHASES)
def test_index_phase_spans(jobs, name, attrs):
    """One span of each phase of the index build, in the order the phases
    run, with its attrs: the postings and the OpenMP team, the unique
    k-mers."""
    _d, rec, _f = jobs["on"]
    (s,) = _named(rec, name)
    assert set(s[4]) == attrs
    assert all(isinstance(v, int) and v > 0 for v in s[4].values())
    starts = [_named(rec, n)[0][2] for n, _a in INDEX_PHASES]
    assert starts == sorted(starts)
    if name == "prefilter.index_hash":
        (post,) = _named(rec, "prefilter.index_postings")
        assert s[4]["unique_kmers"] <= post[4]["postings"]


@pytest.mark.parametrize("name", ["prefilter.match", "prefilter.wait",
                                  "align.enqueue"])
def test_one_span_a_chunk(jobs, name):
    _d, rec, _f = jobs["on"]
    assert sorted(s[4]["chunk"] for s in _named(rec, name)) == CHUNKS
    if name == "prefilter.match":
        assert sum(s[4]["queries"] for s in _named(rec, name)) == 300


@pytest.mark.parametrize("key", ["index", "prefilter", "align", "aggregate"])
def test_stage_times_are_their_spans(jobs, key):
    detail, rec, _f = jobs["on"]

    def total(name):
        return sum(s[3] - s[2] for s in _named(rec, name)) / 1e9

    want = {"index": total("prefilter.index_build"),
            "prefilter": total("prefilter.wait"),
            "align": total("align") - total("prefilter.wait"),
            "aggregate": total("cluster")}[key]
    assert abs(detail[key] - want) < 1e-3


def test_no_span_a_pair(jobs):
    detail, rec, _f = jobs["on"]
    names = [s[0] for s in rec.spans]
    assert detail["align_detail"]["fwd_pairs"] > 100
    assert max(names.count(n) for n in set(names)) <= 4
    counts = {c[0]: c[3] for c in rec.counts}
    assert len(counts) == len(rec.counts)         # one of each a job
    assert set(counts) == {"traceback_pairs", "besthit_groups",
                           "combine_set_pairs", "clusterhits_pairs",
                           "clusterhits_hits", "clusterhits_cells"}
    assert 0 < counts["traceback_pairs"] <= detail["align_detail"]["rev_pairs"]


def test_recording_changes_no_output(jobs):
    """The cluster TSV and the search's result DB are the same bytes with
    recording off and on."""
    def outputs(tag):
        run = jobs[tag][2]["clustersearch"].parent
        files = [run / "out.tsv", *sorted((run / "tmp").glob("*/result")),
                 *sorted((run / "tmp").glob("*/result.index"))]
        return [(p.relative_to(run), p.read_bytes()) for p in files]

    off = outputs("off")
    assert len(off) == 3 and off[0][1].count(b"\n") > 10
    assert outputs("on") == off


def test_traceback_names_its_route(jobs):
    """The sequence search traces every pair in one native batch: each
    `align.traceback` span names the route "seq", and no pair is counted
    on the per-pair route."""
    _d, rec, _f = jobs["on"]
    spans = _named(rec, "align.traceback")
    assert spans and all(s[4] == {"route": "seq"} for s in spans)
    assert all(c[0] != "traceback_pair_calls" for c in rec.counts)


def test_dispatch_carries_its_stage(jobs):
    detail, rec, _f = jobs["on"]
    by_dir = {d: [s[4] for s in _named(rec, "sw.dispatch")
                  if s[4]["dir"] == d] for d in ("fwd", "rev")}
    ad = detail["align_detail"]
    for d in ("fwd", "rev"):
        assert sum(a["pairs"] for a in by_dir[d]) == ad[f"{d}_pairs"]
        assert sum(a["cells"] for a in by_dir[d]) == ad[f"{d}_cells"]


def test_anchors_map_onto_the_epoch_clock(jobs):
    _d, rec, _f = jobs["on"]
    assert len(rec.anchors) >= 2
    p = [a[0] for a in rec.anchors]
    assert p == sorted(p)
    first = min(s[2] for s in rec.spans)
    # the job ran within the last minute of the epoch clock
    assert 0 < time.time_ns() - rec.epoch_ns(first) < 60e9


# --------------------------------------------------------------- clock
def test_span_lies_round_a_profiled_op(tmp_path):
    """A span opened under torch.profiler is recorded without start(),
    and mapped through its anchors and the trace's baseTimeNanoseconds it
    holds the aten::mm that ran inside it."""
    trace.take()
    a = torch.randn(128, 128)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("test.mm"):
            time.sleep(0.005)
            torch.mm(a, a)
            time.sleep(0.005)
    rec = trace.take()
    assert not trace.recording()
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = int(data["baseTimeNanoseconds"])
    mm = next(e for e in data["traceEvents"]
              if e.get("name") == "aten::mm" and e.get("ph") == "X")
    m0 = float(mm["ts"]) * 1e3 + base
    m1 = m0 + float(mm["dur"]) * 1e3
    (s,) = _named(rec, "test.mm")
    assert rec.epoch_ns(s[2]) < m0 < m1 < rec.epoch_ns(s[3])


# ---------------------------------------------------------- --trace-file
@pytest.mark.parametrize("command", ["createsetdb", "clustersearch"])
def test_trace_file(jobs, command):
    _d, rec, files = jobs["on"]
    events = json.loads(files[command].read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    first = (min(s[2] for s in _named(rec, "createsetdb.read"))
             if command == "createsetdb"
             else _named(rec, "clustersearch")[0][2])
    last = (max(s[3] for s in _named(rec, "createsetdb.write"))
            if command == "createsetdb"
            else _named(rec, "clustersearch")[0][3])
    want = sorted(s[0] for s in rec.spans
                  if first <= s[2] and s[3] <= last)
    assert sorted(e["name"] for e in spans) == want
    assert all(e["dur"] >= 0 and e["ts"] > 1e15 for e in spans)
    assert sum(e["name"] == "rss" for e in events) == len(spans)
    tids = {e["tid"] for e in spans}
    named = {e["tid"] for e in events if e["ph"] == "M"}
    assert tids <= named


def test_trace_file_leaves_recording_off(tmp_path):
    trace.take()
    fastas = _genomes(tmp_path)
    _run(["createsetdb", *fastas, str(tmp_path / "db"), "--trace-file",
          str(tmp_path / "t.json")])
    assert not trace.recording()
    assert trace.take().spans == []
    names = [e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"] if e["ph"] == "X"]
    assert names == ["createsetdb.read", "createsetdb.write"]


# ---------------------------------------------------------- recorder
def test_off_span_still_times_its_stage():
    trace.take()
    with trace.span("x") as sp:
        time.sleep(0.002)
    assert sp.seconds >= 0.002
    assert trace.take().spans == []


def test_take_empties_and_stop_ends():
    trace.start()
    with trace.span("a", k=1):
        pass
    trace.count("n", 3)
    first = trace.take()
    assert [s[0] for s in first.spans] == ["a"] and first.spans[0][4] == {
        "k": 1}
    assert [(c[0], c[3]) for c in first.counts] == [("n", 3)]
    with trace.span("b"):
        pass
    second = trace.stop()
    assert [s[0] for s in second.spans] == ["b"]
    assert second.anchors[0] == first.anchors[-1]
    with trace.span("c"):
        pass
    assert trace.take().spans == []


# ----------------------------------------------- structure and shards
def test_structure_search_spans(tmp_path):
    from spacedust_tpu_torch.db.flatdb_ingest import create_setdb_from_flatdb
    from spacedust_tpu_torch.search.structure import structure_search
    base, _ref = synth.write_struct_set(tmp_path, "small")
    db = create_setdb_from_flatdb(base).subrange(0, 40)
    metrics: dict = {}
    trace.start()
    structure_search(db, db, device="cpu", metrics=metrics)
    rec = trace.stop()
    for key, name in (("index_s", "structure.index"),
                      ("prefilter_s", "structure.match"),
                      ("align_all_s", "structure.align")):
        (s,) = _named(rec, name)
        assert metrics[key] == pytest.approx((s[3] - s[2]) / 1e9)
    (align,) = _named(rec, "structure.align")
    for name in ("align.traceback", "align.records", "sw.dispatch"):
        assert _named(rec, name)
        assert all(_within(s, align) for s in _named(rec, name))
    assert all(_within(s, _named(rec, "structure.match")[0])
               for s in _named(rec, "prefilter.match"))
    (index,) = _named(rec, "structure.index")
    for name, attrs in INDEX_PHASES:
        (s,) = _named(rec, name)
        assert _within(s, index) and set(s[4]) == attrs


def test_sharded_engine_spans():
    from spacedust_tpu_torch.parallel.sw_sharded import (ShardedAlignDB,
                                                         make_mesh)
    from spacedust_tpu_torch.stats.submat import load_substitution_matrix
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 20, 600).astype(np.uint8)
    eng = ShardedAlignDB(make_mesh(2, "cpu"), tok, np.zeros(600, np.int8),
                         tok, [(0, 300), (300, 600)],
                         load_substitution_matrix().sub_int)
    jobs = [(np.array([0, 100]), np.array([50, 60]), np.array([10, 400]),
             np.array([70, 80]), np.full(2, -1), np.arange(2))]
    trace.start()
    eng.run_buckets(jobs, 11, 1, reverse=False)
    rec = trace.stop()
    (dispatch,) = _named(rec, "sw.dispatch")
    assert dispatch[4] == {"dir": "fwd", "pairs": 2,
                           "cells": 50 * 70 + 60 * 80}
    assert len(_named(rec, "sw.fetch")) == 1
    assert "dispatch_s" not in eng.metrics and "fetch_s" not in eng.metrics
