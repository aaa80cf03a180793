"""The multi-process clustersearch of the port (ROADMAP A8) and its entry
points (A14), on the CPU: worker processes over a shared tmp dir, a gloo
group at the coordinator (the sentinel files show it formed), the
filesystem barrier without one, the CLI's `--multihost` and
`--multihost-local-devices` against the recorded fixture, `entry()` and
the dry run.  Each merged TSV must equal the single process's, byte for
byte."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.entry import _toy_genomes, dryrun_multichip, entry
from spacedust_tpu_torch.parallel import multihost
from spacedust_tpu_torch.workflow.clustersearch import (ClusterSearchParams,
                                                        cluster_search)

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
PAR = ClusterSearchParams(filter_self_match=True)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """The workers share the host's cores with the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    db = _toy_genomes()
    d = tmp_path_factory.mktemp("toy")
    db.save(d / "db")
    return db, str(d / "db"), cluster_search(db, db, PAR, device="cpu").tsv


@pytest.mark.parametrize("local", [1, 2])
def test_two_procs_equal_single(toy, tmp_path, monkeypatch, local):
    """2 workers, each the single engine or 2 target shards, in a gloo
    group of 2 (the sentinel files name each rank of the world)."""
    db, path, single = toy
    assert any(ln.startswith(">") for ln in single.splitlines())
    monkeypatch.setenv("SPACEDUST_DISTRIBUTED_SENTINEL",
                       str(tmp_path / "group"))
    out = multihost.run_multihost(path, str(tmp_path / "result.tsv"), 2,
                                  PAR, tmp_dir=str(tmp_path / "mh"),
                                  local_devices=local, device="cpu")
    assert Path(out).read_text() == single
    ranks = sorted((p.name, p.read_text())
                   for p in tmp_path.glob("group.rank*"))
    assert ranks == [("group.rank0", "0/2"), ("group.rank1", "1/2")]
    # gloo's barrier ran, not the filesystem's
    assert not list((tmp_path / "mh").glob("search.rank*.done"))
    s2c = multihost.read_seq_to_clu(out)
    want = cluster_search(db, db, PAR, device="cpu").seq_to_clu
    assert s2c == want


def test_filesystem_barrier_without_coordinator(toy, tmp_path, monkeypatch):
    """Without SPACEDUST_COORDINATOR the ranks meet at sentinel files in
    the shared tmp dir: two ranks as two threads of this process."""
    db, path, single = toy
    monkeypatch.delenv("SPACEDUST_COORDINATOR", raising=False)
    monkeypatch.setenv("SPACEDUST_NUM_PROCS", "2")
    tmp, out = tmp_path / "mh", tmp_path / "out.tsv"
    pj = __import__("json").dumps(__import__("dataclasses").asdict(PAR))
    errs = []

    def rank(r):
        try:
            multihost._work(path, tmp, str(out), pj, 1, "cpu", r, 2, False)
        except BaseException as e:          # noqa: BLE001 -- reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in (1, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert sorted(p.name for p in tmp.glob("search.rank*.done")) == [
        "search.rank0.done", "search.rank1.done"]
    assert out.read_text() == single
    assert multihost._init_distributed() == (0, 2, False)


def test_a_group_that_does_not_form_raises(monkeypatch):
    """A coordinator nobody answers at: init fails, it does not fall back
    to the filesystem barrier."""
    monkeypatch.setattr(multihost, "INIT_TIMEOUT_S", 2)
    monkeypatch.setenv("SPACEDUST_COORDINATOR",
                       f"127.0.0.1:{multihost._free_port()}")
    monkeypatch.setenv("SPACEDUST_NUM_PROCS", "2")
    monkeypatch.setenv("SPACEDUST_PROC_ID", "1")
    with pytest.raises(Exception):
        multihost._init_distributed()


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    fastas = synth.write_genome_set(d, "small")
    db = str(d / "db")
    assert cli.main(["createsetdb", *map(str, fastas), db]) == 0
    return db


@pytest.mark.parametrize("flags", [
    ["--multihost", "2", "--multihost-local-devices", "2"],
    ["--multihost", "2"]], ids=["2x2", "2x1"])
def test_cli_equals_fixture(small_db, tmp_path, flags):
    """clustersearch --multihost 2 --multihost-local-devices 2 (2 worker
    processes of 2 target shards) and --multihost 2 alone (2 workers of
    the single engine): the fixture's TSV, and the _seq_to_clu sidecar
    of a single run."""
    out = tmp_path / "out.tsv"
    assert cli.main(["clustersearch", small_db, small_db, str(out),
                     str(tmp_path / "tmp"), "--filter-self-match",
                     "--device", "cpu", *flags]) == 0
    assert out.read_bytes() == (FIXTURES / "torch_port_small.tsv"
                                ).read_bytes()
    assert Path(str(out) + "_seq_to_clu.index").exists()


def test_entry_runs_on_the_cpu():
    fn, args = entry("cpu")
    out = fn(*args)
    assert tuple(out.shape) == (6, 64) and out.dtype == torch.int32
    from spacedust_tpu_torch.ops.sw import sw_jobs_ref
    assert torch.equal(out, sw_jobs_ref(*args, reverse=False))
    assert (out[0] > 0).all() and (out[2] < 200).all()
    assert np.array_equal(args[4][1], np.full(64, 200))


def test_dryrun_multichip_on_the_cpu(capsys):
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "sharded clustersearch == single" in out
    assert "multihost TSV == single-process" in out
