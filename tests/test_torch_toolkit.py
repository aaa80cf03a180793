"""The port's module toolkit (`search`, `convertalignments`,
`besthitbyset`, `mergeresultsbyset`, `combinehits`, `clusterhits`,
`summarizeresults`; SW on the CPU, plain version) against the JAX
package's CLI on the tiny repeat set, file for file and byte for byte, and
against the fixtures the JAX package recorded on `small` and `repeats`
(tools/record_torch_port_fixtures.py toolkit:SET).  The commands come from
workflow/modules.py::toolkit_commands: the search with the alignment
controls, its m8, and the clustersearch workflow one module at a time,
whose last file is clustersearch's TSV."""

from pathlib import Path

import pytest
import torch

from spacedust_tpu import cli as jax_cli
from spacedust_tpu.cluster.aggregate import combine_hits as jax_combine_hits
from spacedust_tpu.cluster.aggregate import \
    merge_results_by_set as jax_merge_results_by_set
from spacedust_tpu.db.setdb import SetDB as JaxSetDB
from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.workflow.modules import OUTPUTS, toolkit_commands

FIXTURES = Path(__file__).resolve().parent / "fixtures"

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def run_port(db: str, out: Path) -> None:
    out.mkdir()
    for _name, argv in toolkit_commands(db, out):
        if argv[0] == "search":
            argv = argv + ["--device", "cpu"]
        assert cli.main(argv) == 0, argv


def run_jax(db: str, out: Path) -> None:
    out.mkdir()
    for _name, argv in toolkit_commands(db, out):
        if argv[0] == "combinehits":
            # the JAX CLI regroups the merged file by gene key where
            # combine_hits wants query sets, so this one module runs
            # through the JAX library, written by the JAX CLI's writer
            qdb = JaxSetDB.load(db)
            merged = jax_merge_results_by_set(
                jax_cli._read_prefixed_tsv(argv[3]), qdb)
            jax_cli._write_matches(argv[4], jax_combine_hits(
                merged, qdb, qdb, filter_self_match=True))
        else:
            assert jax_cli.main(argv) == 0, argv


def make_db(tmp: Path, size: str) -> str:
    fastas = [str(p) for p in synth.write_genome_set(tmp / "faa", size)]
    db = str(tmp / "db")
    assert cli.main(["createsetdb", *fastas, db]) == 0
    return db


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiny")
    db = make_db(tmp, "repeats_tiny")
    run_jax(db, tmp / "jax")
    run_port(db, tmp / "port")
    return db, tmp


@pytest.mark.parametrize("name", OUTPUTS)
def test_command_writes_the_jax_clis_file(tiny_runs, name):
    _db, tmp = tiny_runs
    got = (tmp / "port" / name).read_bytes()
    assert got == (tmp / "jax" / name).read_bytes()
    assert len(got.splitlines()) >= 4


def test_search_format_modes_match_jax(tiny_runs):
    """--format-mode 4 (m8 with a header) and a custom --format-output."""
    db, tmp = tiny_runs
    flags = ["--alt-ali", "1", "--format-mode", "4", "--format-output",
             "query,target,pident,nident,qlen,tlen,raw,cigar,qcov,tcov"]
    got, ref = str(tmp / "fmt_port.m8"), str(tmp / "fmt_jax.m8")
    assert cli.main(["search", db, db, got, *flags, "--device", "cpu"]) == 0
    assert jax_cli.main(["search", db, db, ref, *flags]) == 0
    assert Path(got).read_bytes() == Path(ref).read_bytes()
    assert Path(got).read_text().startswith("query\ttarget\tpident")


def test_chain_equals_clustersearch(tiny_runs):
    db, tmp = tiny_runs
    out = str(tmp / "clustersearch.tsv")
    assert cli.main(["clustersearch", db, db, out, "--filter-self-match",
                     "--device", "cpu"]) == 0
    tsv = Path(out).read_text()
    assert tsv == (tmp / "port" / "chain_result.tsv").read_text()
    assert sum(1 for ln in tsv.splitlines() if ln.startswith("#")) >= 1


@pytest.fixture(scope="module")
def fixture_runs(tmp_path_factory):
    """The port's toolkit run on a recorded set, made on first use."""
    done: dict[str, Path] = {}

    def get(size: str) -> Path:
        if size not in done:
            tmp = tmp_path_factory.mktemp(size)
            run_port(make_db(tmp, size), tmp / "port")
            done[size] = tmp / "port"
        return done[size]
    return get


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("size", ["repeats", "small"])
def test_command_reproduces_the_recorded_fixture(fixture_runs, size, name):
    got = (fixture_runs(size) / name).read_bytes()
    assert got == (FIXTURES / f"torch_port_{size}_{name}").read_bytes()
    if name == "chain_result.tsv":
        assert got == (FIXTURES / f"torch_port_{size}.tsv").read_bytes()


def test_recorded_sets_exercise_the_controls():
    """`small` has no repeated domain, so --alt-ali adds nothing there, but
    its paralog families make --max-accept / --max-rejected cut records;
    on `repeats` the alternative alignments exist."""
    small_alt, small_controls, repeats_alt = (
        (FIXTURES / f"torch_port_{n}").read_text().splitlines()
        for n in ("small_search_alt.tsv", "small_search_controls.tsv",
                  "repeats_search_alt.tsv"))
    assert len(small_controls) < len(small_alt)
    pairs = [tuple(ln.split("\t")[:2]) for ln in repeats_alt]
    assert len(pairs) - len(set(pairs)) >= 10


# ------------------------- the flags that were not ported take their paths
# Each command line once named a ROADMAP item at parse time.  Now each
# either runs (and fails on its input, which does not exist) or is refused
# at parse time because its path does not take a flag beside it (DROPPED).
NOT_PORTED = [
    (["createsetdb", "a.faa", "db", "--gff-dir", "gffs"],
     FileNotFoundError),
    (["createsetdb", "a.faa", "db", "--gff-type", "gene"],
     "--gff-type gene has no effect with protein input"),
    (["createsetdb", "a.faa", "db", "--translation-table", "11"],
     "--translation-table 11 has no effect with protein input"),
    (["clustersearch", "q", "q", "out", "--multihost", "2",
      "--split-memory-limit", "1000"],
     "--split-memory-limit 1000 has no effect with --multihost > 1"),
    (["clustersearch", "q", "t", "--split-memory-limit", "1000",
      "--multihost-local-devices", "2", "out", "--profile-cluster-search"],
     "--multihost-local-devices 2 has no effect with one process "
     "(no --multihost > 1)"),
    (["clustersearch", "q", "q", "out", "--multihost", "2", "--cluster-db",
      "clu"], "--cluster-db clu has no effect with --multihost > 1"),
    (["clustersearch", "q", "t", "out", "--multihost", "2"],
     "--multihost requires query_db == target_db"),
    (["clustersearch", "q", "t", "out", "--device", "cpu",
      "--multihost-local-devices", "2"],
     "--multihost-local-devices 2 has no effect with one process "
     "(no --multihost > 1)"),
    (["search", "q", "t", "out", "--search-type", "3", "--num-iterations",
      "2"], "--num-iterations 2 has no effect with --search-type 3"),
    (["search", "q", "t", "out", "--search-type", "3", "--e-profile",
      "0.01"], "--e-profile 0.01 has no effect with --search-type 3"),
    (["search", "q", "t", "out", "--search-type", "3"], FileNotFoundError),
    (["gff2db", "a.fna", "db", "--gff-dir", "gffs"], FileNotFoundError),
]


@pytest.mark.parametrize("argv,item", NOT_PORTED,
                         ids=[" ".join(a[:1] + a[-2:]) for a, _ in NOT_PORTED])
def test_unported_flag_fails_at_parse_time(capsys, argv, item):
    """No input of these command lines exists: a refused flag fails in the
    parser (exit code 2) with the reason; a command line that parses fails
    on its missing input.  None says that something is not ported."""
    if isinstance(item, str):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2
    else:
        with pytest.raises(item):
            cli.main(argv)
    err = capsys.readouterr().err
    assert "not ported" not in err
    if isinstance(item, str):
        assert item in err


# the flags the structure search does not take, at a value off their
# default (workflow/clustersearch.py::_structure_params)
MODE2_DROPPED = [("-s", "4.0"), ("--gap-open", "10"), ("--gap-extend", "2"),
                 ("--aln-len", "10"), ("--max-accept", "5"),
                 ("--max-rejected", "5"), ("--alt-ali", "2")]


@pytest.mark.parametrize("flag,value", MODE2_DROPPED,
                         ids=[f for f, _ in MODE2_DROPPED])
def test_search_mode_2_refuses_the_flags_it_drops(capsys, flag, value):
    """clustersearch --search-mode 2 refuses each flag its structure
    search ignores, in the parser (exit code 2) with the reason;
    --search-mode 1, whose unmapped genes' sequence search takes the
    flag, parses it and fails on its missing DB."""
    argv = ["clustersearch", "q", "q", "out", flag, value, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--search-mode", "2"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} {value} has no effect with --search-mode 2" in err
    with pytest.raises(FileNotFoundError):
        cli.main(argv + ["--search-mode", "1"])
    assert "has no effect" not in capsys.readouterr().err


KMER_PATHS = [(["--search-mode", "1"], "--search-mode 1"),
              (["--search-mode", "2"], "--search-mode 2"),
              (["--profile-cluster-search"], "--profile-cluster-search")]


@pytest.mark.parametrize("flag,value", [("-k", "7"),
                                        ("--spaced-kmer-mode", "0")],
                         ids=["k", "spaced-kmer-mode"])
@pytest.mark.parametrize("switch,path", KMER_PATHS,
                         ids=["mode1", "mode2", "profile"])
def test_kmer_flags_refused_off_the_sequence_search(capsys, switch, path,
                                                    flag, value):
    """-k and --spaced-kmer-mode reach the prefilter of the sequence
    search (--search-mode 0) only: clustersearch refuses them in the
    parser (exit code 2), naming the flag and the path, with
    --search-mode 1 and 2 and --profile-cluster-search; the sequence
    search parses them and fails on its missing DB."""
    argv = ["clustersearch", "q", "q", "out", flag, value, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + switch)
    assert exc.value.code == 2
    assert f"{flag} {value} has no effect with {path}" in \
        capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        cli.main(argv + ["--search-mode", "0"])
    assert "has no effect" not in capsys.readouterr().err


def test_switched_off_values_pass_the_parser(capsys):
    """The values that switch a feature off parse; the command then fails
    on its missing DB, not in the parser."""
    for argv in (["clustersearch", "q", "t", "o", "--split-memory-limit",
                  "0", "--multihost", "1", "--device", "cpu"],
                 ["search", "q", "t", "o", "--num-iterations", "1",
                  "--search-type", "1", "--device", "cpu"]):
        with pytest.raises(FileNotFoundError):
            cli.main(argv)
    assert "not ported" not in capsys.readouterr().err


def test_search_needs_its_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(["search", "q", "t", "o"])


def test_commands_of_the_port():
    assert len(cli.COMMANDS) == 12
    assert set(cli.COMMANDS) == set(jax_cli.COMMANDS)
