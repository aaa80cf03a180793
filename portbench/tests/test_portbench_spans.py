"""The readers of the program's spans (portbench/spans.py and the metrics
that read it) on hand-made spans with known answers, and in a traced run
of each cell on the CPU; an untraced run reads nothing of the program's
recorder."""

import sys
import types

import pytest

from conftest import small_cell

MS = 1_000_000                       # ns


def _span(name, t0_ms, t1_ms, tid=1, rss=0, **attrs):
    return (name, tid, t0_ms * MS, t1_ms * MS, attrs, rss)


# two jobs: each starts at its createsetdb.read; the matcher on thread 2
SPANS = [
    _span("createsetdb.read", 0, 10, rss=100),
    _span("createsetdb.write", 10, 12, rss=150),
    _span("clustersearch", 20, 120, rss=400),
    _span("prefilter.index_save", 25, 30, rss=300),
    _span("prefilter.match", 30, 50, tid=2, rss=350, chunk=0),
    _span("prefilter.match", 50, 60, tid=2, rss=350, chunk=256),
    _span("align.enqueue", 52, 55, chunk=0),
    _span("align.enqueue", 61, 64, chunk=256),
    _span("align.traceback", 70, 90, rss=500),
    _span("align.records", 90, 95),
    _span("align.records", 96, 97),
    _span("createsetdb.read", 200, 210, rss=200),
    _span("createsetdb.write", 210, 211, rss=210),
    _span("clustersearch", 220, 280, rss=260),
    _span("prefilter.match", 230, 240, tid=2, rss=220, chunk=0),
    _span("align.enqueue", 241, 245, chunk=0),
    _span("align.traceback", 250, 260, rss=230),
    _span("align.records", 260, 262),
]

# the metric, its value in seconds over the two jobs above
READINGS = {
    "search_wall_s": (0.100 + 0.060) / 2,
    "index_save_s": (0.005 + 0.0) / 2,
    "prefilter_busy_s": (0.030 + 0.010) / 2,
    "enqueue_s": (0.006 + 0.004) / 2,
    "traceback_s": (0.020 + 0.010) / 2,
    "records_s": (0.006 + 0.002) / 2,
}


class _Ctx:
    def __init__(self, n_jobs, traced=True):
        self.jobs = [{}] * n_jobs
        self.trace = {"busy_s": 0.0} if traced else None


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in for the program's recorder, holding SPANS."""
    from portbench import spans
    fake = types.SimpleNamespace(
        snapshot=lambda: types.SimpleNamespace(spans=list(SPANS)))
    monkeypatch.setitem(sys.modules, spans.RECORDER, fake)
    return fake


def test_split_jobs_at_each_ingest():
    from portbench import spans
    jobs = spans.split_jobs(SPANS, 2)
    assert [len(j) for j in jobs] == [11, 7]
    assert spans.split_jobs(SPANS, 3) is None
    # the last job alone: an earlier window's spans are left out
    (last,) = spans.split_jobs(SPANS, 1)
    assert last == SPANS[11:]


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(recorder, name):
    from portbench import bench
    got = bench.load_metric(name).read(_Ctx(2))
    assert got == pytest.approx(READINGS[name])


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_finds_nothing(monkeypatch, recorder, name):
    """Nothing to read in an untraced run, or from a program without the
    recorder (the parent of the change that added it)."""
    from portbench import bench, spans
    reader = bench.load_metric(name)
    assert reader.read(_Ctx(2, traced=False)) is None
    monkeypatch.delitem(sys.modules, spans.RECORDER)
    assert reader.read(_Ctx(2)) is None


def test_rss_growth():
    from portbench import spans
    jobs = spans.split_jobs(SPANS, 2)
    # job 1: 500 - 100 (its first span's); job 2: 260 - 200
    assert spans.rss_growth_gib(jobs) == pytest.approx(
        (400 + 60) / 2 / 2**30)


def test_idle_unattributed_layout():
    """Window 0-100 with the card busy over 10-20 and 60-70: 80 idle.  The
    stage spans cover 0-30 (0-10 and 20-30 idle: 20), 50-55 (5) and
    90-120 (90-100: 10), so 45 of the 80 are named by no stage."""
    from portbench import spans
    got = spans.idle_unattributed_pct(
        windows=[(0, 40), (40, 100)], busy=[(10, 20), (60, 70), (65, 68)],
        stage_spans=[(0, 30), (50, 55), (90, 120), (52, 54)])
    assert got == pytest.approx(100 * 45 / 80)
    assert spans.idle_unattributed_pct([(0, 10)], [(0, 10)], []) is None
    assert spans.idle_unattributed_pct([(0, 10)], [], [(0, 10)]) == 0


@pytest.mark.parametrize("name", ["seq.regression", "struct.regression"])
def test_traced_run_reads_every_span_metric(local_cache, name):
    from portbench import bench
    cell = small_cell(name)
    out = bench.run_cell(cell, 2**31 + 5, 0.01, True, device="cpu")
    assert out["correct"], out["checks"]
    want = {m["name"] for m in cell.per_layer} & set(READINGS)
    assert want == ({"search_wall_s", "traceback_s", "records_s"}
                    | ({"index_save_s", "prefilter_busy_s", "enqueue_s"}
                       if name == "seq.regression" else set()))
    for m in want:
        assert out["metrics"][m]["value"] > 0, m
    # the program's own total lies inside the harness's span round it
    assert out["metrics"]["search_wall_s"]["value"] <= max(
        t[1] for t in out["job_times"])


def test_untraced_run_reads_no_span(local_cache, monkeypatch):
    from portbench import bench
    from spacedust_tpu_torch.utils import trace

    def refuse():
        raise AssertionError("an untraced run read the recorder")

    monkeypatch.setattr(trace, "snapshot", refuse)
    monkeypatch.setattr(trace, "take", refuse)
    out = bench.run_cell(small_cell(), 2**31 + 6, 0.01, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"job_s", "host_peak_gib", "setup_s"}
