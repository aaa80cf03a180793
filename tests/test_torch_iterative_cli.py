"""`search --num-iterations` of the port through its CLI (SW on the CPU,
plain version): byte for byte equal to the JAX package's CLI, recorded
(tests/fixtures/torch_port_{small,families}_iterN.tsv, by
tools/record_torch_port_fixtures.py) and live; and the parse-time refusal
of the flags that the JAX package's iterative search takes and ignores."""

import json

import pytest
import torch

from spacedust_tpu import cli as jax_cli
from spacedust_tpu_torch import cli, synth

# the test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

FIXTURES = __import__("pathlib").Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The port's setDBs of the small and the family set."""
    out = {}
    for size in ("small", "families"):
        d = tmp_path_factory.mktemp(size)
        db = str(d / "db")
        fastas = synth.write_genome_set(d, size)
        assert cli.main(["createsetdb", *map(str, fastas), db]) == 0
        out[size] = db
    return out


@pytest.mark.parametrize("size,n_iter", [("small", 2), ("small", 3),
                                         ("families", 2)])
def test_cli_iterative_equals_jax_fixture(dbs, tmp_path, capsys, size,
                                          n_iter):
    db = dbs[size]
    out = tmp_path / "out.tsv"
    assert cli.main(["search", db, db, str(out), "--num-iterations",
                     str(n_iter), "--device", "cpu"]) == 0
    want = (FIXTURES / f"torch_port_{size}_iter{n_iter}.tsv").read_bytes()
    assert out.read_bytes() == want
    detail = next(json.loads(ln.split("detail: ", 1)[1])
                  for ln in capsys.readouterr().out.splitlines()
                  if "detail: " in ln)
    rounds = detail["rounds"]
    assert [m["round"] for m in rounds] == list(range(n_iter))
    n_lines = len(want.decode().splitlines())
    assert sum(m["records"] for m in rounds) == n_lines
    if size == "families":
        # the profile round matters here: JAX's adds >= 20 records (the
        # recorder asserts it), and so does the port's, the same ones
        assert rounds[1]["records"] >= 20


def test_cli_e_profile_matches_jax(tmp_path):
    """search --num-iterations 2 with -e and --e-profile set, through both
    CLIs, byte for byte, on the family set's first genome."""
    fastas = synth.write_genome_set(tmp_path, "families")[:1]
    db = str(tmp_path / "db")
    assert cli.main(["createsetdb", *map(str, fastas), db]) == 0
    flags = ["--num-iterations", "2", "-e", "0.01", "--e-profile", "1e-4"]
    out, jout = tmp_path / "port.tsv", tmp_path / "jax.tsv"
    assert cli.main(["search", db, db, str(out), *flags,
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["search", db, db, str(jout), *flags]) == 0
    assert out.read_bytes() == jout.read_bytes()
    assert len(out.read_text().splitlines()) > 90


DROPPED = [("-k", "7"), ("--spaced-kmer-mode", "0"), ("--max-accept", "3"),
           ("--max-rejected", "5"), ("--alt-ali", "1")]


@pytest.mark.parametrize("flag,value", DROPPED)
def test_cli_refuses_flags_iterative_search_drops(tmp_path, capsys, flag,
                                                  value):
    """The JAX package's iterative search ignores these flags; the port
    refuses them at parse time, naming the flag, and takes them at their
    default value."""
    argv = ["search", "q", "q", str(tmp_path / "o.tsv"), "--num-iterations",
            "2", flag, value, "--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "--num-iterations" in err


def test_cli_takes_defaults_and_one_iteration(tmp_path):
    """Default values of those flags pass with --num-iterations 2 (the run
    then fails on the missing DB, after parsing), and any value passes
    with one iteration."""
    for argv in (["--num-iterations", "2", "--max-accept", "2147483647",
                  "-k", "0"], ["--num-iterations", "1", "-k", "7"]):
        with pytest.raises(FileNotFoundError):
            cli.main(["search", str(tmp_path / "none"), str(tmp_path / "none"),
                      str(tmp_path / "o.tsv"), *argv, "--device", "cpu"])


FAMILY_SHA256 = {
    "genome_a.faa":
        "0ec3a13f082ac754757afc8270b75a62da3c6df67a079b844bc9cda3585537a0",
    "genome_b.faa":
        "c4cac0d8e1f37e84adf46198ef80086a61655071c09792fa0166672384cb8023",
}


def test_synth_family_set_unchanged(tmp_path):
    """The family set writes the bytes its fixture was recorded from."""
    import hashlib
    for path in synth.write_genome_set(tmp_path, "families"):
        assert (hashlib.sha256(path.read_bytes()).hexdigest()
                == FAMILY_SHA256[path.name])
