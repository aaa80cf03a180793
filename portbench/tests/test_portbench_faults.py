"""A run with the timed path broken underneath comes out not correct, for
each fault a one-card job can have (faults.py), and the int8 control,
put in the program's place, comes out not correct where the program
comes out correct."""

import pytest

from conftest import small_cell

# the number each fault has to fail
FAILS = {"unchanged": "output_missing", "half": "pairs_missed",
         "altered": "sw_wrong", "altered_hits": "hits_unbacked",
         "altered_traceback": "traceback_wrong"}


@pytest.mark.parametrize("fault", sorted(FAILS))
def test_fault_is_caught(local_cache, fault):
    from portbench import bench, faults
    with faults.planted(fault):
        out = bench.run_cell(small_cell(), 41, 0.01, False, device="cpu")
    assert out["correct"] is False
    c = out["checks"][FAILS[fault]]
    assert c["value"] > c["limit"]


def test_faults_are_undone(local_cache):
    from portbench import bench, faults
    with faults.planted("altered"):
        pass
    out = bench.run_cell(small_cell(), 41, 0.01, False, device="cpu")
    assert out["correct"], out["checks"]


def _readings(cell, seed, device, tmp_path):
    from portbench.control import readings
    return readings(cell, seed, device, None, tmp_path)


def test_int8_control_fails_where_the_program_passes(local_cache, tmp_path):
    cell = small_cell()
    r = _readings(cell, 43, "cpu", tmp_path)
    assert r["correct"] is True, r["program"]
    assert r["control_correct"] is False
    assert r["control"]["sw_wrong"] > cell.spec["limits"]["sw_wrong"]


@pytest.mark.chip
@pytest.mark.parametrize("name", ["seq.regression", "struct.regression"])
def test_int8_control_on_the_card(local_cache, tmp_path, cuda, name):
    """The control on the card, three seeds, at the small size."""
    cell = small_cell(name)
    for seed in (51, 52, 53):
        r = _readings(cell, seed, cuda, tmp_path / str(seed))
        assert r["correct"] is True, r["program"]
        assert r["control_correct"] is False
