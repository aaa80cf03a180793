"""clusterdb of the port (sequence clustering, MSA, PSSM and consensus per
representative, the rep->member alignments) and the profile cluster search
through the CLI, on the CPU (the SW passes run their plain version),
against the JAX package: live on tiny seeded sets, and against the
JAX-recorded fixtures of the `small` set
(tools/record_torch_port_fixtures.py profile:small).  Everything compared
is equal, not close: cluster maps, every ClusterDB array with its dtype,
the clu_aln lines, the TSV."""

from pathlib import Path

import numpy as np
import pytest
import torch

from spacedust_tpu.cluster.cascade import cascaded_cluster as jax_cascade
from spacedust_tpu.cluster.seqcluster import (
    SeqClusterParams as JaxSeqParams, cluster_sequences as jax_cluster)
from spacedust_tpu.db.fasta import create_setdb_from_fastas as jax_fastas
from spacedust_tpu.workflow.clusterdb import ClusterDB as JaxClusterDB
from spacedust_tpu.workflow.clusterdb import cluster_db as jax_cluster_db
from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.cluster.cascade import cascaded_cluster
from spacedust_tpu_torch.cluster.seqcluster import (
    MODE_CONNECTED_COMPONENT, MODE_GREEDY, MODE_SET_COVER, SeqClusterParams,
    cluster_sequences)
from spacedust_tpu_torch.db.fasta import create_setdb_from_fastas
from spacedust_tpu_torch.workflow.clusterdb import (ClusterDB,
                                                    ClusterDBParams,
                                                    cluster_db,
                                                    cluster_db_cached)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

AAS = "ACDEFGHIKLMNPQRSTVWY"


def _protein(rng, n):
    return "".join(AAS[i] for i in rng.integers(0, 20, n))


def _mutate(rng, seq, n_mut):
    s = list(seq)
    for pos in rng.choice(len(s), size=n_mut, replace=False):
        s[pos] = AAS[rng.integers(0, 20)]
    return "".join(s)


def _write_faa(path, genes):
    with open(path, "w") as fh:
        for i, seq in enumerate(genes):
            start = 100 + i * 1000
            fh.write(f">ctg_{i+1} # {start} # {start+len(seq)*3-1} # 1 # X\n")
            fh.write(seq + "\n")


def homolog_fastas(d, seed=11):
    """Two genomes: four families, each with a copy in either genome and
    one or two paralogs of 4-12 % mutations (clusters of 2-4 members, real
    MSAs), a near-duplicate pair for linclust, and a unique gene each."""
    rng = np.random.default_rng(seed)
    fams = [_protein(rng, n) for n in (120, 150, 100, 180)]
    g1, g2 = [_protein(rng, 80)], [_protein(rng, 70)]
    for i, f in enumerate(fams):
        g1.append(f)
        g2.append(_mutate(rng, f, len(f) // 12))
        for _ in range(1 + i % 2):
            g1.append(_mutate(rng, f, len(f) // 25))
    dup = _protein(rng, 130)
    g1.append(dup)
    g2.append(_mutate(rng, dup, 1))
    _write_faa(d / "g1.faa", g1)
    _write_faa(d / "g2.faa", g2)
    return [str(d / "g1.faa"), str(d / "g2.faa")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    fa = homolog_fastas(tmp_path_factory.mktemp("tiny"))
    return create_setdb_from_fastas(fa), jax_fastas(fa)


def cdb_lines(cdb):
    return {k: [r.line() for r in v] for k, v in cdb.clu_aln.items()}


def assert_cdb_equal(got, want):
    """Clusters, representatives, every array with its dtype, the clu_aln
    lines."""
    assert got.rep_keys == want.rep_keys
    assert got.clusters == want.clusters
    for name in ("pssms", "aln_profiles", "consensus", "query_seqs"):
        a, b = getattr(got, name), getattr(want, name)
        assert sorted(a) == sorted(b), name
        for k in want.rep_keys:
            assert a[k].dtype == b[k].dtype, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    assert cdb_lines(got) == cdb_lines(want)


@pytest.mark.parametrize("mode", [MODE_SET_COVER, MODE_CONNECTED_COMPONENT,
                                  MODE_GREEDY])
def test_cluster_sequences_matches_jax(tiny, mode):
    db, jdb = tiny
    kw = dict(seq_id_thr=0.5, mode=mode)
    got = cluster_sequences(db, SeqClusterParams(**kw), device="cpu")
    want = jax_cluster(jdb, JaxSeqParams(**kw))
    assert got == want
    assert sorted(k for v in got.values() for k in v) == list(range(db.size))
    assert sum(len(v) > 1 for v in got.values()) >= 4


def test_cascaded_cluster_matches_jax(tiny):
    db, jdb = tiny
    got = cascaded_cluster(db, device="cpu")
    assert got == jax_cascade(jdb)
    assert sorted(k for v in got.values() for k in v) == list(range(db.size))


@pytest.mark.parametrize("single_step", [True, False])
def test_cluster_db_matches_jax(tiny, single_step):
    """Every array of the profile target, live against the JAX package:
    clusters with several members make real MSAs."""
    db, jdb = tiny
    from spacedust_tpu.workflow.clusterdb import (
        ClusterDBParams as JaxCDBParams)
    metrics: dict = {}
    got = cluster_db(db, ClusterDBParams(single_step_clustering=single_step),
                     device="cpu", metrics=metrics)
    want = jax_cluster_db(jdb, JaxCDBParams(
        single_step_clustering=single_step))
    assert_cdb_equal(got, want)
    assert sum(len(v) > 1 for v in got.clusters.values()) >= 3
    for stage in ("cluster_s", "profiles_s", "clu_aln_s"):
        assert metrics[stage] >= 0
    for rep in got.rep_keys:
        assert any(r.tkey == rep for r in got.clu_aln[rep])


def test_clusterdb_directory_loads_across_packages(tiny, tmp_path):
    """A ClusterDB directory written by either package loads in the other
    with every array and line equal."""
    db, jdb = tiny
    ours = cluster_db(db, device="cpu")
    ours.save(tmp_path / "port")
    assert_cdb_equal(JaxClusterDB.load(tmp_path / "port"), ours)
    theirs = jax_cluster_db(jdb)
    theirs.save(tmp_path / "jax")
    assert_cdb_equal(ClusterDB.load(tmp_path / "jax"), theirs)
    assert_cdb_equal(ClusterDB.load(tmp_path / "jax"), ours)
    # the cached form loads what is there and builds nothing
    assert_cdb_equal(cluster_db_cached(db, tmp_path / "jax", device="cpu"),
                     ours)


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    path = str(d / "db")
    fa = synth.write_genome_set(d, "small")
    assert cli.main(["createsetdb", *map(str, fa), path]) == 0
    return path


@pytest.mark.parametrize("name,flags", [
    ("torch_port_small_clu", []),
    ("torch_port_small_clu_cascade", ["--single-step-clustering", "0"])])
def test_clusterdb_cli_matches_fixture(small_db, tmp_path, name, flags):
    """`clusterdb --device cpu` on the small set writes the directory the
    JAX package's CLI wrote, array for array; the set has clusters of
    several members."""
    out = tmp_path / "clu"
    assert cli.main(["clusterdb", small_db, str(out), *flags,
                     "--device", "cpu"]) == 0
    want = ClusterDB.load(FIXTURES / name)
    assert_cdb_equal(ClusterDB.load(out), want)
    assert sum(len(v) >= 2 for v in want.clusters.values()) >= 3


def test_profile_cluster_search_cli_matches_fixture(small_db, tmp_path):
    """clustersearch --filter-self-match --profile-cluster-search through
    the CLI on the CPU, over the JAX-written ClusterDB directory, writes
    the JAX package's TSV and its gene -> cluster sidecar byte for
    byte."""
    out = tmp_path / "out.tsv"
    assert cli.main(["clustersearch", small_db, small_db, str(out),
                     str(tmp_path / "tmp"), "--filter-self-match",
                     "--profile-cluster-search", "--cluster-db",
                     str(FIXTURES / "torch_port_small_clu"),
                     "--device", "cpu"]) == 0
    want = (FIXTURES / "torch_port_small_profile.tsv").read_text()
    assert out.read_text() == want
    assert want.count("\n>") >= 20 and want.count("#") >= 3
    for ext in ("", ".index", ".dbtype"):
        name = "_seq_to_clu" + ext
        assert (Path(str(out) + name).read_bytes() == (
            FIXTURES / ("torch_port_small_profile.tsv" + name)).read_bytes())


def test_clusterdb_needs_its_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["clusterdb", "db"])
