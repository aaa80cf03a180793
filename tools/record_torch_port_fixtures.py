"""Record the fixtures the PyTorch port is held against, from the JAX
package on the CPU:

  tests/fixtures/torch_port_small.tsv   result TSV of the small synthetic set
  tests/fixtures/torch_port_real.json   hit / cluster counts and the
                                        canonical-TSV sha256 of the
                                        real-size synthetic set

Both runs are `clustersearch --filter-self-match` of the two-genome set
against itself, as written by `spacedust_tpu_torch.synth` at its default
seed.  Usage:

  JAX_PLATFORMS=cpu python tools/record_torch_port_fixtures.py [small|real]...
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
from spacedust_tpu.workflow.clustersearch import (  # noqa: E402
    ClusterSearchParams, cluster_search)
from spacedust_tpu_torch import synth  # noqa: E402
from spacedust_tpu_torch.cluster.summarize import canonical_sha256  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures"


def run(size: str) -> str:
    with tempfile.TemporaryDirectory() as d:
        paths = synth.write_genome_set(d, size)
        db = create_setdb_from_fastas(paths)
        t0 = time.time()
        res = cluster_search(db, db, ClusterSearchParams(
            filter_self_match=True))
        print(f"{size}: {db.size} genes, {time.time() - t0:.1f} s, "
              f"timings {res.timings}", file=sys.stderr)
        return res.tsv


def main(argv: list[str]) -> int:
    for size in argv or ["small", "real"]:
        tsv = run(size)
        if size == "small":
            (FIXTURES / "torch_port_small.tsv").write_text(tsv)
            continue
        lines = tsv.splitlines()
        rec = {"seed": synth.SEED, "sizes": list(synth.SIZES[size]),
               "hits": sum(1 for ln in lines if ln.startswith(">")),
               "clusters": sum(1 for ln in lines if ln.startswith("#")),
               "canonical_sha256": canonical_sha256(tsv)}
        (FIXTURES / f"torch_port_{size}.json").write_text(
            json.dumps(rec, indent=1) + "\n")
        print(rec, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
