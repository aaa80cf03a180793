"""The PyTorch port imports without JAX and never reaches the JAX package.

Runs in a subprocess: this pytest process has already imported jax
(tests/conftest.py)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import spacedust_tpu_torch
# __main__ runs the CLI when imported, by design
names = [m.name for m in pkgutil.walk_packages(
    spacedust_tpu_torch.__path__, "spacedust_tpu_torch.")
    if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
for name in ("spacedust_tpu_torch.search.structure",
             "spacedust_tpu_torch.workflow.aa2foldseek",
             "spacedust_tpu_torch.search.convert",
             "spacedust_tpu_torch.workflow.modules",
             "spacedust_tpu_torch.search.profile",
             "spacedust_tpu_torch.search.msafilter",
             "spacedust_tpu_torch.search.expandaln",
             "spacedust_tpu_torch.search.profilesearch",
             "spacedust_tpu_torch.cluster.seqcluster",
             "spacedust_tpu_torch.cluster.cascade",
             "spacedust_tpu_torch.workflow.clusterdb",
             "spacedust_tpu_torch.search.iterative",
             "spacedust_tpu_torch.parallel.split",
             "spacedust_tpu_torch.parallel.merge",
             "spacedust_tpu_torch.parallel.pipeline",
             "spacedust_tpu_torch.parallel.sw_sharded",
             "spacedust_tpu_torch.parallel.multihost",
             "spacedust_tpu_torch.entry",
             "spacedust_tpu_torch.db.gff",
             "spacedust_tpu_torch.db.translate",
             "spacedust_tpu_torch.db.orftools",
             "spacedust_tpu_torch.db.dbtools",
             "spacedust_tpu_torch.utils.expr",
             "spacedust_tpu_torch.search.nucl",
             "spacedust_tpu_torch.cli"):
    assert name in names and name in sys.modules, name
leaked = sorted(m for m in sys.modules
                if m == "spacedust_tpu" or m.startswith("spacedust_tpu.")
                or m.startswith("jax."))
print(len(names), leaked)
assert not leaked, leaked
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


# the multi-process worker: what `python -m ...parallel.multihost` loads
# up to its search stage, with jax made unimportable
_WORKER_PROBE = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["multihost", "--help"]
try:
    runpy.run_module("spacedust_tpu_torch.parallel.multihost",
                     run_name="__main__")
except SystemExit:
    pass
import spacedust_tpu_torch.parallel.pipeline
import spacedust_tpu_torch.workflow.clustersearch
import spacedust_tpu_torch.cluster.summarize
leaked = sorted(m for m in sys.modules
                if m == "spacedust_tpu" or m.startswith("spacedust_tpu.")
                or m.startswith("jax."))
assert not leaked, leaked
print("ok")
"""


def test_worker_subprocess_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"
