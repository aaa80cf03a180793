"""The frozen generator writes, from the traffic files, the program's
generator's bytes at its seed, and records what it planted."""

import filecmp

import pytest

from conftest import ROOT

SEED = 20261016


def _traffic(name, shape_seed=None):
    """A traffic file's parameters; with the shape drawn from the run's
    seed unless shape_seed is given."""
    import json
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                   .read_text())
    return dict(t, shape_seed=shape_seed)


def test_sequence_set_is_byte_identical(tmp_path):
    from portbench.gen import synth
    from spacedust_tpu_torch import synth as program
    genomes, truth = synth.make_genomes((4300, 1600), SEED,
                                        _traffic("regression_shape"))
    synth.write_genome_set(tmp_path / "frozen", genomes)
    program.write_genome_set(tmp_path / "program", "real", SEED)
    for name in ("genome_a.faa", "genome_b.faa"):
        assert filecmp.cmp(tmp_path / "frozen" / name,
                           tmp_path / "program" / name, shallow=False)
    assert len(truth.blocks) == 20
    assert all(len(b) >= 3 for b in truth.blocks)


def test_structure_set_is_byte_identical(tmp_path):
    from portbench.gen import synth
    from spacedust_tpu_torch import synth as program
    genomes, truth = synth.make_struct_genomes(
        (4300, 1600), SEED, _traffic("regression_shape_3di"))
    synth.write_struct_set(tmp_path / "frozen", genomes)
    program.write_struct_set(tmp_path / "program", "real", SEED)
    names = sorted(p.name for p in (tmp_path / "frozen").iterdir())
    assert "genomes_ss" in names
    for name in names:
        assert filecmp.cmp(tmp_path / "frozen" / name,
                           tmp_path / "program" / name, shallow=False)
    assert max(len(g[0]) for gs in genomes for g in gs) <= 2700


def test_planted_pairs_are_homologs():
    """Each recorded pair's B gene came from its A gene: by the reference
    SW its planted pairs at 50 % identity or more score far above the
    same genes paired at random."""
    import numpy as np
    from portbench.gen import synth
    from portbench.reference.judge import Inputs, sw_answers
    genomes, truth = synth.make_genomes((150, 150), 7,
                                        _traffic("regression_shape"))
    inputs = Inputs(genomes, truth, "seq", 11, 1)
    close = [(inputs.key(ga, a), inputs.key(gb, b))
             for ga, a, gb, b, ident, _s in truth.pairs if ident >= 50]
    rng = np.random.default_rng(0)
    shuffled = [(q, inputs.key(1, int(rng.integers(0, 150))))
                for q, _t in close]
    bits = sw_answers(inputs, close + shuffled, "cpu")
    planted = [bits[k][0] for k in close]
    chance = [bits[k][0] for k in shuffled]
    assert len(close) >= 10
    assert min(planted) > 40 and np.median(chance) < 30


@pytest.mark.parametrize("maker,name", [("make_genomes", "regression_shape"),
                                        ("make_struct_genomes",
                                         "regression_shape_3di")])
def test_fixed_shape_gives_every_seed_the_same_sizes(maker, name):
    """With shape_seed, two seeds give the same gene lengths, homolog
    placement and identities, and other residues."""
    from portbench.gen import synth
    make = getattr(synth, maker)
    t = _traffic(name, shape_seed=99)
    (g1, t1), (g2, t2) = make((300, 200), 1, t), make((300, 200), 2, t)
    assert t1.pairs == t2.pairs and t1.blocks == t2.blocks
    n1 = [len(x[0]) for gs in g1 for x in gs]
    n2 = [len(x[0]) for gs in g2 for x in gs]
    unplanted = [i for i in range(len(n1)) if n1[i] == n2[i]]
    assert len(unplanted) > 0.8 * len(n1)     # indels move a few lengths
    assert any((x[0] != y[0]).any() for x, y in zip(g1[0], g2[0])
               if len(x[0]) == len(y[0]))


def test_unknown_traffic_parameter_is_refused():
    from portbench.gen import synth
    with pytest.raises(ValueError):
        synth.params({"no_such_key": 1})
