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

Every run is `clustersearch --filter-self-match` of a two-genome set
against itself, as written by `spacedust_tpu_torch.synth` at its default
seed (the structure sets through a pre-built flat DB, as `createsetdb`
ingests them).  Usage:

  JAX_PLATFORMS=cpu python tools/record_torch_port_fixtures.py \
      [small|real|struct_small|struct_small_mode1|struct_real[:SIZE]]...
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
from spacedust_tpu_torch import synth  # noqa: E402
from spacedust_tpu_torch.cluster.summarize import canonical_sha256  # noqa: E402

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


def summary(tsv: str, size: str) -> dict:
    lines = tsv.splitlines()
    return {"seed": synth.SEED, "sizes": list(synth.SIZES[size]),
            "hits": sum(1 for ln in lines if ln.startswith(">")),
            "clusters": sum(1 for ln in lines if ln.startswith("#")),
            "canonical_sha256": canonical_sha256(tsv)}


def main(argv: list[str]) -> int:
    for target in argv or ["small", "real"]:
        name, _, size = target.partition(":")
        if name == "small":
            (FIXTURES / "torch_port_small.tsv").write_text(run("small"))
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
