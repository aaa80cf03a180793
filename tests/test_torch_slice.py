"""The port's clustersearch slice (SW on the CPU, plain version) against
the JAX package on the small synthetic genome set, and against the
fixture the JAX package recorded (tests/fixtures/torch_port_small.tsv,
tools/record_torch_port_fixtures.py)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.workflow.clustersearch import ClusterSearchParams as JaxCSP
from spacedust_tpu.workflow.clustersearch import cluster_search as jax_search
from spacedust_tpu_torch import synth
from spacedust_tpu_torch.cluster.summarize import canonical_blocks
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.workflow.clustersearch import (ClusterSearchParams,
                                                        cluster_search)
from test_e2e_regression import canonical

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port_small.tsv"

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    return synth.write_genome_set(tmp_path_factory.mktemp("small"), "small")


def _counts(tsv: str) -> tuple[int, int]:
    lines = tsv.splitlines()
    return (sum(1 for ln in lines if ln.startswith(">")),
            sum(1 for ln in lines if ln.startswith("#")))


def test_cluster_search_matches_jax(fastas):
    db = create_setdb_from_fastas(fastas)
    got = cluster_search(db, db, ClusterSearchParams(filter_self_match=True),
                         device="cpu")
    jdb = jax_fastas(fastas)
    ref = jax_search(jdb, jdb, JaxCSP(filter_self_match=True))
    assert canonical(got.tsv) == canonical(ref.tsv)
    assert canonical_blocks(got.tsv) == canonical(ref.tsv)
    assert ([dataclasses.astuple(m) for m in got.matches]
            == [dataclasses.astuple(m) for m in ref.matches])
    assert canonical(got.tsv) == canonical(FIXTURE.read_text())
    hits, clusters = _counts(got.tsv)
    assert hits >= 10 and clusters >= 2
    assert got.timings["align_detail"]["fwd_pairs"] > 0


def test_cli_matches_fixture(fastas, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run = [sys.executable, "-m", "spacedust_tpu_torch"]
    db, out = str(tmp_path / "db"), str(tmp_path / "result.tsv")
    for args in (["createsetdb", *map(str, fastas), db],
                 ["clustersearch", db, db, out, str(tmp_path / "tmp"),
                  "--filter-self-match", "--device", "cpu"]):
        res = subprocess.run(run + args, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
    tsv = Path(out).read_text()
    assert canonical(tsv) == canonical(FIXTURE.read_text())
    assert Path(out + "_seq_to_clu.index").exists()
