"""The harness finds every configuration, traffic mix, cell and metric by
the name BENCHMARK.json gives it, and a cell added by files and entries
alone runs with no other file edited; BENCHMARK.json keeps to its
contract's form."""

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_file(bench_json):
    from portbench import bench
    for w in bench_json["workloads"]:
        cell = bench.load_cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.kind in ("seq", "struct")
        assert set(cell.spec["limits"]) >= {"sw_wrong", "hits_unbacked",
                                            "pairs_missed", "blocks_missed",
                                            "jobs_differ", "output_missing"}
    for m in bench_json["per_layer"]:
        assert callable(bench.load_metric(m["name"]).read)
    for c in bench_json["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]


@pytest.mark.parametrize("key", ["name", "config", "traffic"])
def test_names_keep_the_contract(bench_json, key):
    for w in bench_json["workloads"]:
        assert NAME.match(w[key])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1


def test_metrics_keep_the_contract(bench_json):
    names = [m["name"] for m in bench_json["end_to_end"]
             + bench_json["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench_json["workloads"]}
    for m in bench_json["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench_json["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] == "job_s"
        assert set(m["workloads"]) <= cells
    assert any(m["name"] == "setup_s" for m in bench_json["end_to_end"])
    roof = [m for m in bench_json["per_layer"] if "roofline" in m["name"]]
    assert all(m["name"].endswith("_roofline") and m["unit"] == "%"
               for m in roof)


def test_every_cell_reports_a_layer_metric(bench_json):
    for w in bench_json["workloads"]:
        assert any(w["name"] in m["workloads"]
                   for m in bench_json["per_layer"])


def test_added_cell_needs_no_edit(tmp_path):
    """A copy of the benchmark with a cell, a traffic mix and a metric
    added by new files and new entries only."""
    from portbench import bench
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((here / "traffic" / "regression_shape.json")
                         .read_text())
    traffic["homolog_ident"] = [50, 96]
    (here / "traffic" / "close_homologs.json").write_text(json.dumps(traffic))
    spec = json.loads((here / "workloads" / "seq.regression.json")
                      .read_text())
    (here / "workloads" / "seq.close.json").write_text(json.dumps(spec))
    (here / "metrics" / "jobs_run.py").write_text(
        "def read(ctx):\n    return float(len(ctx.jobs))\n")
    data["workloads"].append({"name": "seq.close",
                              "config": "seq-ecoli-hpylori",
                              "traffic": "close_homologs", "chips": 1,
                              "why": "closer homologs"})
    data["per_layer"].append({"name": "jobs_run", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "job_s",
                              "workloads": ["seq.close"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = bench.load_cell(tmp_path, "seq.close", here=here)
    assert cell.traffic["homolog_ident"] == [50, 96]
    assert [m["name"] for m in cell.per_layer] == ["jobs_run"]
    assert bench.load_metric("jobs_run", here=here).read(
        type("C", (), {"jobs": [1, 2]})()) == 2.0
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()
             and p.relative_to(here) in before}
    assert after == before
