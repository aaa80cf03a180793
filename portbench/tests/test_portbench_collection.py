"""Genome collections (a configuration's `genomes` above 2): the two cells
that came before them keep their inputs and their judge's numbers byte for
byte, and a collection parses, is planted as stated and is judged."""

import hashlib
import json

import numpy as np
import pytest

from conftest import ROOT, small_cell

# sha256 over (file name, bytes) of the inputs make_inputs writes, and of
# the Truth as (gene of A, gene of B, identity, 3Di identity) and blocks,
# taken on the tree before collections existed
INPUTS = {
    ("seq.regression", 7):
        "e5a8454502aed9fcd5d198f07616b856346e18f278e5d5e4ebf45a576f899c7d",
    ("seq.regression", 2**31 + 11):
        "799e9d478aa1d6b9da4f3f5f8a09ff4770829edd6cf8059e775b6ab7fd1947db",
    ("struct.regression", 7):
        "0f79371e5b81d7e4546a41f395868202f1c5a6480576631ab4d5847c8f806116",
    ("struct.regression", 2**31 + 11):
        "8e09db0cdb06ed444d2552e6517ee00478e4b4dcb99f2615fc279c7a9f8714dd",
}
TRUTH = {
    "seq.regression":
        "61130d6b747b03930411fd2e594767ecce3b4f4598db61c2e93bb5aa33ea8c77",
    "struct.regression":
        "0198d61ffe0c3ae7b480e13823b9588ee34aabfe5ea2511856e1f5a49ed89054",
}
# the judge's numbers on one small job's outputs (seed 31), taken on the
# same tree: the program's, the int8 control's, and under the half fault
_ZERO = {"output_missing": 0, "jobs_differ": 0, "sw_wrong": 0,
         "traceback_wrong": 0, "hits_unbacked": 0, "hits_not_best": 0}
JUDGED = {
    ("seq.regression", None): (
        dict(_ZERO, sw_checked=77, tb_checked=77, pairs_missed=0.0,
             blocks_missed=0.0),
        dict(_ZERO, sw_wrong=72, sw_checked=77, tb_checked=77,
             pairs_missed=0.0, blocks_missed=0.0)),
    ("seq.regression", "half"): (
        dict(_ZERO, sw_checked=27, tb_checked=27, pairs_missed=0.75,
             blocks_missed=0.5), None),
    ("struct.regression", None): (
        dict(_ZERO, sw_checked=105, tb_checked=105, pairs_missed=0.0,
             blocks_missed=0.0),
        dict(_ZERO, sw_wrong=104, sw_checked=105, tb_checked=105,
             pairs_missed=0.0, blocks_missed=0.0)),
    ("struct.regression", "half"): (
        dict(_ZERO, sw_checked=51, tb_checked=51,
             pairs_missed=0.46153846153846156, blocks_missed=0.75), None),
}


def _traffic(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                      .read_text())


def _digest(directory) -> str:
    h = hashlib.sha256()
    for p in sorted(directory.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(INPUTS))
def test_earlier_cells_keep_their_inputs(tmp_path, name, seed):
    from portbench import bench
    cell = bench.load_cell(ROOT, name)
    _paths, inputs = bench.make_inputs(cell, cell.config["genes"], seed,
                                       tmp_path)
    assert _digest(tmp_path) == INPUTS[(name, seed)]
    pairs = [[a, b, ident, ss] for ga, a, gb, b, ident, ss
             in inputs.truth.pairs if (ga, gb) == (0, 1)]
    assert len(pairs) == len(inputs.truth.pairs)
    assert hashlib.sha256(json.dumps([pairs, inputs.truth.blocks])
                          .encode()).hexdigest() == TRUTH[name]


@pytest.mark.parametrize("name,fault", sorted(JUDGED, key=str))
def test_earlier_cells_keep_their_judged_numbers(local_cache, tmp_path,
                                                  name, fault):
    from portbench.control import readings
    r = readings(small_cell(name), 31, "cpu", fault, tmp_path)
    program, control = JUDGED[(name, fault)]
    assert r["program"] == program
    assert r.get("control") == control


# ------------------------------------------------------------ collections
def _collection(n=3, seed=9, sizes=(150, 150)):
    from portbench.gen import synth
    from portbench.reference.judge import Inputs
    genomes, truth = synth.make_genomes(sizes, seed,
                                        _traffic("regression_shape"), n)
    return Inputs(genomes, truth, "seq", 11, 1)


def test_collection_parses_through_createsetdb(tmp_path):
    """Three FASTAs, one set each, with every gene in the order and at the
    key that the judge gives it."""
    from portbench.gen import synth
    from spacedust_tpu_torch import cli
    from spacedust_tpu_torch.db.setdb import SetDB
    inputs = _collection()
    paths = synth.write_genome_set(tmp_path / "in", inputs.genomes)
    assert [p.name for p in paths] == ["genome_a.faa", "genome_b.faa",
                                       "genome_c.faa"]
    assert cli.main(["createsetdb", *map(str, paths),
                     str(tmp_path / "db")]) == 0
    db = SetDB.load(tmp_path / "db")
    assert db.num_sets == 3
    assert db.set_sizes.tolist() == [len(g) for g in inputs.genomes]
    assert db.lengths.tolist() == [len(g[0]) for g in inputs.genes]
    for k in (0, inputs.key(1, 0), inputs.key(2, 5), len(inputs.genes) - 1):
        assert inputs.key_of_name(db.names[k]) == k
        assert int(db.set_ids[k]) == inputs.genome(k)


def test_collection_is_derived_as_stated():
    """Alternately from A and from B, each keeping about 90 % of its
    source's genes; every planted pair joins two derived genomes, and
    pairs of one source gene have IDENT^2 / 100 identity."""
    from portbench.gen import synth
    inputs = _collection(n=4, sizes=(400, 300))
    sizes = [len(g) for g in inputs.genomes]
    assert all(0.8 * 400 < n < 400 for n in sizes[0::2])
    assert all(0.8 * 300 < n < 300 for n in sizes[1::2])
    genomes = {frozenset((ga, gb))
               for ga, _a, gb, _b, _i, _s in inputs.truth.pairs}
    assert genomes == {frozenset((a, b)) for a in range(4)
                       for b in range(a + 1, 4)}
    same = [p for p in inputs.truth.pairs if p[0] % 2 == p[2] % 2]
    assert {p[4] for p in same} == {synth.IDENT ** 2 // 100}
    assert len(same) > 0.7 * (400 + 300)
    assert all(len(b) >= 2 for b in inputs.truth.blocks)
    for block in inputs.truth.blocks:
        (ga, gb), = {inputs.truth.pairs[k][0:3:2] for k in block}
        assert ga % 2 == 0 and gb % 2 == 1


def test_collection_pairs_are_homologs():
    """By the reference's SW and traceback, each planted pair aligns at
    about its recorded identity."""
    from portbench.reference.judge import reference_columns
    inputs = _collection()
    keys = [(inputs.key(ga, a), inputs.key(gb, b))
            for ga, a, gb, b, _i, _s in inputs.truth.pairs]
    cols = reference_columns(inputs, keys, keys, "cpu")
    gap = np.array([100 * float(cols[k][0]) - p[4]
                    for k, p in zip(keys, inputs.truth.pairs)
                    if p[4] >= 50 and cols[k][0] is not None])
    assert len(gap) >= 100
    assert abs(np.median(gap)) < 3
    assert np.percentile(np.abs(gap), 90) < 15


def _collection_cell(genomes=3):
    cell = small_cell()
    cell.config = dict(cell.config, genomes=genomes)
    return cell


def test_collection_job_is_judged(local_cache):
    """A job on three genomes is correct, every exact number at 0."""
    from portbench import bench
    out = bench.run_cell(_collection_cell(), 2**31 + 5, 0.01, False,
                         device="cpu")
    assert out["correct"], out["checks"]
    for name in _ZERO:
        assert out["checks"][name]["value"] == 0


def test_collection_half_fault_is_caught(local_cache):
    from portbench import bench, faults
    with faults.planted("half"):
        out = bench.run_cell(_collection_cell(), 2**31 + 5, 0.01, False,
                             device="cpu")
    assert out["correct"] is False
    assert 0.35 < out["checks"]["pairs_missed"]["value"] < 0.65


def test_structure_collection_is_refused(tmp_path):
    from portbench import bench
    cell = small_cell("struct.regression")
    cell.config = dict(cell.config, genomes=3)
    with pytest.raises(ValueError, match="two genomes"):
        bench.make_inputs(cell, (150, 150), 1, tmp_path)


def test_collection_shape_is_the_seeds(tmp_path):
    """With shape_seed, two seeds derive the same collection: the same
    gene counts and planted pairs and blocks."""
    from portbench.gen import synth
    t = dict(_traffic("regression_shape"), shape_seed=99)
    (g1, t1), (g2, t2) = (synth.make_genomes((300, 200), s, t, 4)
                          for s in (1, 2))
    assert [len(g) for g in g1] == [len(g) for g in g2]
    assert t1.pairs == t2.pairs and t1.blocks == t2.blocks
