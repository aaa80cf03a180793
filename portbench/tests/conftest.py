"""Shared set-up of the benchmark's tests.  They run on the CPU (the
program's plain SW path); a test marked `chip` needs the card and skips
here, deciding so inside the test through the `cuda` fixture."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return "cuda"


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    """The program's seed tables, built once for the session."""
    d = tmp_path_factory.mktemp("seed_tables")
    os.environ["SPACEDUST_CACHE_DIR"] = str(d)
    return d


SHORT_GENES = [[30, 100, 50], [100, 200, 50]]


def small_cell(name: str = "seq.regression", genes=(150, 150)):
    """A cell of BENCHMARK.json at the generator's smallest sound size
    (150 + 150 genes, fewer would leave its planting no room) and with
    genes of 30-200 aa, so that the program's plain SW on the CPU takes a
    second a job; its judge and limits are the cell's own."""
    from portbench import bench
    cell = bench.load_cell(ROOT, name)
    cell.config = dict(cell.config, genes=list(genes))
    cell.spec = dict(cell.spec, warmup_genes=list(genes))
    cell.traffic = dict(cell.traffic, length_bins=SHORT_GENES)
    return cell


@pytest.fixture
def local_cache(monkeypatch, cache_dir):
    """The harness's seed-table cache pointed at the session's."""
    from portbench import bench
    monkeypatch.setattr(bench, "CACHE", cache_dir)
    return cache_dir


@pytest.fixture
def bench_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
