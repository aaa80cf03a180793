"""What the benchmark loads: no module whose top-level name is jax,
jaxlib, flax or the JAX package spacedust_tpu (compared whole, so that
spacedust_tpu_torch does not match), not the program's own generator; and
the plain reference loads nothing of the program."""

import json
import subprocess
import sys

from conftest import ROOT

RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import os
os.environ["SPACEDUST_CACHE_DIR"] = {cache!r}
from portbench import bench
bench.CACHE = __import__("pathlib").Path({cache!r})
from conftest import small_cell
out = bench.run_cell(small_cell(), 3, 0.01, True, device="cpu")
print(json.dumps({{"correct": out["correct"],
                   "modules": sorted(sys.modules)}}))
"""

REF = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.judge, portbench.reference.sw
import portbench.reference.scoring
print(json.dumps(sorted(sys.modules)))
"""


def _top(names):
    return {n.split(".")[0] for n in names}


def test_a_run_loads_no_jax(tmp_path):
    code = RUN.format(root=str(ROOT), tests=str(ROOT / "portbench/tests"),
                      cache=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["correct"]
    top = _top(got["modules"])
    assert "spacedust_tpu_torch" in top          # the program ran
    assert not top & {"jax", "jaxlib", "flax", "spacedust_tpu"}
    assert "spacedust_tpu_torch.synth" not in got["modules"]


def test_the_reference_loads_nothing_of_the_program():
    r = subprocess.run([sys.executable, "-c", REF.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    top = _top(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"spacedust_tpu_torch", "spacedust_tpu", "jax"}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    from portbench import bench
    monkeypatch.setitem(sys.modules, "spacedust_tpu_torch_extra", sys)
    assert "spacedust_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spacedust_tpu.fake", sys)
    assert "spacedust_tpu" in bench.forbidden_modules()
