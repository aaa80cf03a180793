"""The GFF ingest of the port (ROADMAP A11b: `createsetdb --gff-dir`,
`gff2db`, db/gff.py, db/translate.py) against the JAX package on the same
inputs: the codon translation over every table, the SetDB of contigs plus
GFF3 in every array, name, header and source, the CLI, the real-size
ingest digest and the clustersearch over an ingested set against their
recorded fixtures.  Equal, not close; inputs made from seeds
(`synth.py --gff`: genes on both strands, a non-CDS feature, a CDS under
3 nt)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from spacedust_tpu.db import gff as jax_gff
from spacedust_tpu.db import translate as jax_translate
from spacedust_tpu_torch import cli, synth
from spacedust_tpu_torch.db import gff, translate
from spacedust_tpu_torch.db.setdb import SetDB

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"


def assert_same_db(got, want):
    for name in ("seq_data", "offsets", "set_ids", "pos_idx", "starts",
                 "ends", "lengths"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.names == want.names and got.headers == want.headers
    assert got.sources == want.sources and got.dbtype == want.dbtype


@pytest.fixture(scope="module")
def gffset(tmp_path_factory):
    d = tmp_path_factory.mktemp("gff")
    fnas, gffs = synth.write_gff_set(d, "small")
    listing = d / "gffs.tsv"
    assert listing.read_text() == "".join(f"{g}\n" for g in gffs)
    return d, fnas, gffs, listing


# ------------------------------------------------------------ translate
@pytest.mark.parametrize("table", sorted(jax_translate._NCBI_TABLES))
def test_translate_matches_jax(table):
    """Random codons over the IUPAC letters (ambiguous bases, U, lower
    case), lengths that are not a multiple of 3, every codon of ACGT."""
    rng = np.random.default_rng(table)
    letters = np.frombuffer(b"ACGTUNRYSWKMBDHVacgtn", dtype=np.uint8)
    for n in (0, 1, 2, 3, 301, 1000):
        seq = letters[rng.integers(0, len(letters), n)].tobytes()
        assert (translate.translate(seq, table)
                == jax_translate.translate(seq, table))
    every = "".join(a + b + c for a in "TCAG" for b in "TCAG" for c in "TCAG")
    assert (translate.translate(every.encode(), table)
            == jax_translate.translate(every.encode(), table))
    assert translate.stop_codons(table) == jax_translate.stop_codons(table)
    for all_starts in (False, True):
        assert (translate.start_codons(table, all_starts)
                == jax_translate.start_codons(table, all_starts))


# ------------------------------------------------------------ ingest
@pytest.mark.parametrize("gff_type", ["CDS", "CDS,tRNA", "gene", "tRNA"])
def test_create_setdb_from_gff_matches_jax(gffset, gff_type):
    _d, fnas, gffs, _ = gffset
    got = gff.create_setdb_from_gff(gffs, fnas, gff_type=gff_type)
    want = jax_gff.create_setdb_from_gff(gffs, fnas, gff_type=gff_type)
    assert_same_db(got, want)
    assert got.size > 0


def test_gff_edge_cases(gffset):
    """Minus-strand genes are reverse-complemented and named end_start;
    the CDS of 2 nt is skipped but takes its index; set ids and sources
    follow the GFF files."""
    _d, fnas, gffs, _ = gffset
    db = gff.create_setdb_from_gff(gffs, fnas)
    fa = synth.make_genomes(synth.SIZES["small"])
    names = [n.rsplit("_", 3) for n in db.names]
    assert [int(n[1]) for n in names[:4]] == [0, 1, 2, 4]
    minus = [k for k, n in enumerate(names) if int(n[2]) > int(n[3])]
    assert minus and len(minus) < db.size
    genes = [g for genome in fa for g in genome]
    assert all((genes[k][1] < 0) == (k in set(minus)) for k in range(db.size))
    # each protein comes back, its stop codon an X
    for k in (0, minus[0], db.size - 1):
        assert np.array_equal(db.sequence(k)[:-1], genes[k][0])
        assert db.sequence(k)[-1] == 20
    assert db.sources == [g.name for g in gffs]
    assert np.array_equal(np.unique(db.set_ids), [0, 1])


def test_real_ingest_equals_jax_digest(tmp_path):
    """The real-size set's ingest: its digest is the one the JAX package
    gave (tests/fixtures/torch_port_real_gff.json)."""
    fx = json.loads((FIXTURES / "torch_port_real_gff.json").read_text())
    assert fx["seed"] == synth.SEED
    size = next(k for k, v in synth.SIZES.items() if list(v) == fx["sizes"])
    fnas, gffs = synth.write_gff_set(tmp_path, size)
    got = gff.ingest_digest(gff.create_setdb_from_gff(gffs, fnas))
    assert got == {k: fx[k] for k in ("genes", "residues", "sha256")}


# ------------------------------------------------------------ CLI
def test_cli_createsetdb_and_gff2db(gffset, tmp_path):
    """createsetdb --gff-dir (a listing file, the reference's form) and
    gff2db write the library's SetDB; protein flags with contigs fail."""
    _d, fnas, gffs, listing = gffset
    want = gff.create_setdb_from_gff(gffs, fnas, gff_type="CDS,tRNA",
                                     translation_table=11)
    flags = ["--gff-type", "CDS,tRNA", "--translation-table", "11"]
    fna = [str(p) for p in fnas]
    for i, argv in enumerate((
            ["createsetdb", *fna, "OUT", "--gff-dir", str(listing), *flags],
            ["gff2db", *fna, "OUT", "--gff-dir", str(listing), *flags])):
        out = str(tmp_path / f"db{i}")
        assert cli.main([out if a == "OUT" else a for a in argv]) == 0
        assert_same_db(SetDB.load(out), want)
    with pytest.raises(ValueError, match="requires --gff-dir"):
        cli.main(["createsetdb", *fna, str(tmp_path / "x")])


def test_clustersearch_over_gff_equals_fixture(gffset, tmp_path):
    _d, fnas, _gffs, listing = gffset
    db, out = str(tmp_path / "db"), tmp_path / "out.tsv"
    assert cli.main(["createsetdb", *map(str, fnas), db, "--gff-dir",
                     str(listing)]) == 0
    assert cli.main(["clustersearch", db, db, str(out), "--filter-self-match",
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == (FIXTURES / "torch_port_small_gff.tsv"
                                ).read_bytes()
    # the _seq_to_clu sidecar, as the JAX package's CLI wrote it
    for ext in ("", ".index", ".dbtype"):
        assert (Path(f"{out}_seq_to_clu{ext}").read_bytes()
                == (FIXTURES / f"torch_port_small_gff.tsv_seq_to_clu{ext}"
                    ).read_bytes())
