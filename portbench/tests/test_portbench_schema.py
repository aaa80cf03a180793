"""The result line: its keys, their types, the numbers compared last; the
traced run's per-layer metrics, device times and breakdown; the entry's
refusals."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, small_cell

E2E = {"job_s", "host_peak_gib", "setup_s"}


def _check_common(out, cell):
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] >= 1
    assert out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
        assert c["limit"] == cell.spec["limits"][name]
    json.dumps(out)


@pytest.mark.parametrize("name", ["seq.regression", "struct.regression"])
def test_untraced_line(local_cache, name):
    from portbench import bench
    cell = small_cell(name)
    out = bench.run_cell(cell, 2**31 + 11, 0.01, False, device="cpu")
    _check_common(out, cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == E2E
    for m in out["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert "breakdown" not in out


def test_traced_line(local_cache):
    from portbench import bench
    cell = small_cell()
    out = bench.run_cell(cell, 5, 0.01, True, device="cpu")
    _check_common(out, cell)
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names
    # the host spans read on any machine; the card's only on the card
    assert {"ingest_s", "index_s", "prefilter_wait_s", "align_s",
            "aggregate_s"} <= set(out["metrics"])
    assert "sw_roofline" not in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_no_result_without_a_card_or_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder (no program), or on a machine with no card, the entry exits
    non-zero and prints no result."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "seq.regression", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_unknown_workload_is_refused():
    from portbench import bench
    with pytest.raises(KeyError):
        bench.load_cell(ROOT, "no.such.cell")


def test_trace_summary(tmp_path):
    """Busy time is the union of device intervals inside the window; gaps
    carry the innermost harness span."""
    from portbench import trace
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation",
           "name": "portbench.clustersearch", "ts": 100, "dur": 800},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.job",
           "ts": 50, "dur": 900},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 250, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 900,
           "dur": 200}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(p)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["device_ops"][0] == ["k", pytest.approx(200e-6)]
    assert s["idle_gaps"][0] == ["clustersearch", pytest.approx(550e-6)]
