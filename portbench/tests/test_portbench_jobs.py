"""Every step of the window is a fresh user job: its DB directory and tmp
dir do not exist before it, no k-mer index of an earlier job is on disk,
and the jobs of one window give the same outputs."""

from pathlib import Path

from conftest import small_cell


def test_each_job_is_fresh(local_cache, monkeypatch):
    from portbench import bench
    from spacedust_tpu_torch import cli
    seen = []
    real_main = cli.main

    def watching(argv):
        if argv[0] == "createsetdb":
            db = Path(argv[-1])
            root = db.parent.parent
            seen.append({"db": db.exists(),
                         "tmp": (db.parent / "tmp").exists(),
                         "index": sorted(p.name for p in
                                         root.rglob("kmeridx_*")),
                         "others": sorted(p.name for p in root.iterdir()
                                          if p.name.startswith("job")
                                          and p != db.parent)})
        return real_main(argv)

    monkeypatch.setattr(cli, "main", watching)
    out = bench.run_cell(small_cell(), 31, 12.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    window = seen[1:]                       # seen[0] is the warm-up
    assert len(window) == out["attempted"]
    for s in window:
        assert not s["db"] and not s["tmp"]
        assert s["index"] == []             # no earlier job's k-mer index
        assert s["others"] == []            # the previous job was deleted
    assert out["checks"]["jobs_differ"]["value"] == 0


def test_run_job_refuses_a_used_directory(tmp_path):
    import pytest
    from portbench import bench
    (tmp_path / "job").mkdir()
    with pytest.raises(FileExistsError):
        bench.run_job(lambda argv: 0, tmp_path / "job", [], small_cell(),
                      "cpu")
