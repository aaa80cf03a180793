"""Record the fixtures the PyTorch port is held against, from the JAX
package on the CPU:

  tests/fixtures/torch_port_small.tsv   result TSV of the small synthetic set
  tests/fixtures/torch_port_real.json   hit / cluster counts and the
                                        canonical-TSV sha256 of the
                                        real-size synthetic set
  tests/fixtures/torch_port_struct_small.tsv
                                        --search-mode 2 result TSV of the
                                        small structure set
  tests/fixtures/torch_port_struct_small_mode1.tsv
                                        aa2foldseek + --search-mode 1
                                        result TSV of the small structure set
  tests/fixtures/torch_port_struct_real.json
                                        --search-mode 2 counts and sha256 of
                                        the structure set at SIZE (default
                                        real; any key of synth.SIZES)
  tests/fixtures/torch_port_SET_<file>  the module toolkit on SET (small or
                                        repeats): every file that
                                        workflow/modules.py::toolkit_commands
                                        writes, through the JAX package's CLI
                                        (`search` with --alt-ali 2
                                        --max-accept 3 --max-rejected 2 and
                                        with --alt-ali 2 alone, its m8, and
                                        the workflow chain module by module;
                                        combinehits through the library, see
                                        jax_combinehits)
  tests/fixtures/torch_port_repeats.tsv result TSV of the repeat set
  tests/fixtures/torch_port_small_clu/  `clusterdb` of the small set
                                        through the JAX package's CLI
                                        (a ClusterDB directory)
  tests/fixtures/torch_port_small_clu_cascade/
                                        the same with
                                        --single-step-clustering 0
  tests/fixtures/torch_port_small_profile.tsv
                                        `clustersearch --filter-self-match
                                        --profile-cluster-search
                                        --cluster-db` of the small set
                                        against torch_port_small_clu/
  tests/fixtures/torch_port_SET_iterN.tsv
                                        `search --num-iterations N` of SET
                                        through the JAX package's CLI
                                        (iterative:small writes N = 2 and 3,
                                        iterative:families N = 2; the latter
                                        asserts that the profile round adds
                                        at least 20 records to round 0)

`split:small` writes nothing: it asserts that the JAX package's
clustersearch with --split-memory-limit (400,000 and 150,000 bytes, 4 and
9 target splits; and --profile-cluster-search over torch_port_small_clu/
at 64,000,000 bytes, 3-4 profile slices) gives torch_port_small.tsv and
torch_port_small_profile.tsv.

Every run is `clustersearch --filter-self-match` of a two-genome set
against itself, as written by `spacedust_tpu_torch.synth` at its default
seed (the structure sets through a pre-built flat DB, as `createsetdb`
ingests them).  Usage:

  JAX_PLATFORMS=cpu python tools/record_torch_port_fixtures.py \
      [small|real|struct_small|struct_small_mode1|struct_real[:SIZE]|
       repeats|toolkit:small|toolkit:repeats|profile:small|
       iterative:small|iterative:families|split:small]...

The --alt-ali runs align one masked pair a call and compile for every
(query length, target length) they meet: toolkit:repeats took 22 s and
toolkit:small 55 s on a CPU (search_controls.tsv, the first to compile,
15 s and 40 s of that).  profile:small takes about 2 minutes (the two
clusterdb runs and the profile search, whose numpy k-mer index of the
profiles holds 55 M postings at this size).  The `half` set is not
recorded for the profile search: that index would hold about 600 M
postings there, tens of GB.  iterative:small takes about 2 minutes,
iterative:families about 30 s and split:small about 2 minutes.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from spacedust_tpu.db.fasta import create_setdb_from_fastas  # noqa: E402
from spacedust_tpu.db.flatdb_ingest import create_setdb_from_flatdb  # noqa: E402
from spacedust_tpu.workflow.aa2foldseek import (  # noqa: E402
    StructureRef, aa2foldseek)
from spacedust_tpu.workflow.clustersearch import (  # noqa: E402
    ClusterSearchParams, cluster_search)
from spacedust_tpu import cli as jax_cli  # noqa: E402
from spacedust_tpu_torch import synth  # noqa: E402
from spacedust_tpu_torch.cluster.summarize import canonical_sha256  # noqa: E402
from spacedust_tpu_torch.workflow.modules import toolkit_commands  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"


def run(size: str, search_mode: int | None = None) -> str:
    """search_mode None: the FASTA set; 1 or 2: the structure set."""
    with tempfile.TemporaryDirectory() as d:
        kw = {}
        if search_mode is None:
            db = create_setdb_from_fastas(synth.write_genome_set(d, size))
        else:
            base, ref = synth.write_struct_set(d, size)
            db = create_setdb_from_flatdb(base)
            if search_mode == 1:
                m = aa2foldseek(db, StructureRef.open(ref))
                kw = {"query_mapping": m, "target_mapping": m}
        t0 = time.time()
        res = cluster_search(db, db, ClusterSearchParams(
            filter_self_match=True, search_mode=search_mode or 0), **kw)
        print(f"{size} mode {search_mode or 0}: {db.size} genes, "
              f"{time.time() - t0:.1f} s, timings {res.timings}",
              file=sys.stderr)
        return res.tsv


def jax_combinehits(argv: list[str]) -> None:
    """combinehits of the JAX package through its library.  Its CLI
    cannot chain mergeresultsbyset into combinehits: the merged file's
    lines lead with the gene key, and cmd_combinehits groups them by that
    column where combine_hits wants them by query set (ROADMAP C8)."""
    from spacedust_tpu.cluster.aggregate import (combine_hits,
                                                 merge_results_by_set)
    from spacedust_tpu.db.setdb import SetDB
    _cmd, qdb_path, _tdb, merged_tsv, out, *flags = argv
    assert flags == ["--filter-self-match"], flags
    qdb = SetDB.load(qdb_path)
    # the lines of a merged file in file order are those of the best-hit
    # file it was merged from, so merging them again restores the sets
    merged = merge_results_by_set(jax_cli._read_prefixed_tsv(merged_tsv),
                                  qdb)
    jax_cli._write_matches(out, combine_hits(merged, qdb, qdb,
                                             filter_self_match=True))


def toolkit(size: str) -> None:
    """The module toolkit on the set `size` through the JAX CLI."""
    with tempfile.TemporaryDirectory() as d:
        db = str(Path(d) / "db")
        fastas = [str(p) for p in synth.write_genome_set(d, size)]
        assert jax_cli.main(["createsetdb", *fastas, db]) == 0
        for name, argv in toolkit_commands(db, d):
            t0 = time.time()
            if argv[0] == "combinehits":
                jax_combinehits(argv)
            else:
                assert jax_cli.main(argv) == 0, argv
            print(f"toolkit:{size} {name}: {time.time() - t0:.1f} s",
                  file=sys.stderr)
            (FIXTURES / f"torch_port_{size}_{name}").write_bytes(
                (Path(d) / name).read_bytes())


def profile(size: str) -> None:
    """clusterdb (both clusterings) and the profile cluster search on the
    set `size` through the JAX CLI; the default ClusterDB directory is the
    one the search runs against."""
    import shutil
    with tempfile.TemporaryDirectory() as d:
        db = str(Path(d) / "db")
        fastas = [str(pth) for pth in synth.write_genome_set(d, size)]
        assert jax_cli.main(["createsetdb", *fastas, db]) == 0
        clu = FIXTURES / f"torch_port_{size}_clu"
        for out, flags in ((clu, []),
                           (FIXTURES / f"torch_port_{size}_clu_cascade",
                            ["--single-step-clustering", "0"])):
            shutil.rmtree(out, ignore_errors=True)
            t0 = time.time()
            assert jax_cli.main(["clusterdb", db, str(out), *flags]) == 0
            print(f"profile:{size} clusterdb {flags}: "
                  f"{time.time() - t0:.1f} s", file=sys.stderr)
        out = FIXTURES / f"torch_port_{size}_profile.tsv"
        t0 = time.time()
        assert jax_cli.main(["clustersearch", db, db, str(out),
                             str(Path(d) / "tmp"), "--filter-self-match",
                             "--profile-cluster-search", "--cluster-db",
                             str(clu)]) == 0
        print(f"profile:{size} clustersearch: {time.time() - t0:.1f} s",
              file=sys.stderr)


def iterative(size: str) -> None:
    """`search --num-iterations N` on the set `size` through the JAX CLI;
    the records of round 0 are counted where the profiles are built from
    them."""
    import spacedust_tpu.search.iterative as jax_iterative
    round0 = []
    build = jax_iterative.build_profiles

    def counting(qdb, tdb, records, eval_profile):
        round0.append(sum(len(v) for v in records.values()))
        return build(qdb, tdb, records, eval_profile)

    jax_iterative.build_profiles = counting
    try:
        with tempfile.TemporaryDirectory() as d:
            db = str(Path(d) / "db")
            fastas = [str(p) for p in synth.write_genome_set(d, size)]
            assert jax_cli.main(["createsetdb", *fastas, db]) == 0
            for n in ((2, 3) if size == "small" else (2,)):
                out = FIXTURES / f"torch_port_{size}_iter{n}.tsv"
                round0.clear()
                t0 = time.time()
                assert jax_cli.main(["search", db, db, str(out),
                                     "--num-iterations", str(n)]) == 0
                total = len(out.read_text().splitlines())
                print(f"iterative:{size} {n} iterations: {total} records, "
                      f"round 0 {round0[0]}, {time.time() - t0:.1f} s",
                      file=sys.stderr)
                if size == "families":
                    assert total - round0[0] >= 20, (total, round0)
    finally:
        jax_iterative.build_profiles = build


def split(size: str) -> None:
    """--split-memory-limit through the JAX library: the sequence search
    at two budgets and the sliced profile search, each equal to the
    unsplit fixture."""
    from spacedust_tpu.parallel.split import splits_for_memory_budget
    from spacedust_tpu.search.profilesearch import profile_slices
    from spacedust_tpu.workflow.clusterdb import ClusterDB
    with tempfile.TemporaryDirectory() as d:
        db = create_setdb_from_fastas(synth.write_genome_set(d, size))
        want = (FIXTURES / f"torch_port_{size}.tsv").read_text()
        for budget, n in ((400_000, 4), (150_000, 9)):
            assert len(splits_for_memory_budget(db.lengths, budget)) == n
            t0 = time.time()
            res = cluster_search(db, db, ClusterSearchParams(
                filter_self_match=True, split_memory_limit=budget))
            assert res.tsv == want, budget
            print(f"split:{size} {n} target splits: equal "
                  f"({time.time() - t0:.1f} s)", file=sys.stderr)
        cdb = ClusterDB.load(FIXTURES / f"torch_port_{size}_clu")
        budget = 64_000_000
        n = len(profile_slices(cdb, budget))
        assert 3 <= n <= 4, n
        t0 = time.time()
        res = cluster_search(db, db, ClusterSearchParams(
            filter_self_match=True, profile_cluster_search=True,
            split_memory_limit=budget), target_cluster_db=cdb)
        assert res.tsv == (FIXTURES
                           / f"torch_port_{size}_profile.tsv").read_text()
        print(f"split:{size} {n} profile slices: equal "
              f"({time.time() - t0:.1f} s)", file=sys.stderr)


def summary(tsv: str, size: str) -> dict:
    lines = tsv.splitlines()
    return {"seed": synth.SEED, "sizes": list(synth.SIZES[size]),
            "hits": sum(1 for ln in lines if ln.startswith(">")),
            "clusters": sum(1 for ln in lines if ln.startswith("#")),
            "canonical_sha256": canonical_sha256(tsv)}


def main(argv: list[str]) -> int:
    for target in argv or ["small", "real"]:
        name, _, size = target.partition(":")
        if name in ("small", "repeats"):
            (FIXTURES / f"torch_port_{name}.tsv").write_text(run(name))
        elif name == "toolkit":
            toolkit(size)
        elif name == "profile":
            profile(size)
        elif name == "iterative":
            iterative(size)
        elif name == "split":
            split(size)
        elif name == "real":
            rec = summary(run("real"), "real")
            (FIXTURES / "torch_port_real.json").write_text(
                json.dumps(rec, indent=1) + "\n")
            print(rec, file=sys.stderr)
        elif name == "struct_small":
            (FIXTURES / "torch_port_struct_small.tsv").write_text(
                run("small", 2))
        elif name == "struct_small_mode1":
            (FIXTURES / "torch_port_struct_small_mode1.tsv").write_text(
                run("small", 1))
        elif name == "struct_real":
            size = size or "real"
            rec = summary(run(size, 2), size)
            (FIXTURES / "torch_port_struct_real.json").write_text(
                json.dumps(rec, indent=1) + "\n")
            print(rec, file=sys.stderr)
        else:
            raise SystemExit(f"unknown fixture {target!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
