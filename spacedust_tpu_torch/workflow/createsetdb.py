"""createsetdb workflow: protein FASTA inputs -> SetDB artifact.

Mirrors src/workflow/createsetdb.cpp:20-140: expands a directory or .tsv
list into file names (with --file-include/--file-exclude regex), then
runs the amino-acid (Prodigal headers) path.  A single input with a
`.dbtype` file is a pre-built MMseqs2/Foldseek DB (with its `_ss` 3Di
sidecar, if any) and goes through db/flatdb_ingest.py.  The nucleotide
(GFF) input is not ported yet (ROADMAP A11b) and raises.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..db.fasta import create_setdb_from_fastas
from ..db.setdb import SetDB


def expand_inputs(inputs: list[str],
                  file_include: str = ".*",
                  file_exclude: str = "^$") -> list[str]:
    inc = re.compile(file_include)
    exc = re.compile(file_exclude)
    if len(inputs) == 1 and Path(inputs[0]).is_dir():
        out = []
        stack = [Path(inputs[0])]
        while stack:
            d = stack.pop()
            for p in d.iterdir():
                if p.is_dir():
                    stack.append(p)
                elif inc.search(p.name) and not exc.search(p.name):
                    out.append(str(p))
        return out
    if len(inputs) == 1 and inputs[0].endswith(".tsv"):
        return [ln.strip() for ln in Path(inputs[0]).read_text().splitlines()
                if ln.strip()]
    return list(inputs)


def create_setdb(inputs: list[str], out_path: str | None = None,
                 gff_dir: str | None = None,
                 file_include: str = ".*",
                 file_exclude: str = "^$") -> SetDB:
    # pre-built MMseqs2/Foldseek DB input (createsetdb.sh:51-77 "external"
    # path): copy sequences (+ _ss 3Di sidecar) and rewrite the lookup
    if len(inputs) == 1 and Path(f"{inputs[0]}.dbtype").exists():
        from ..db.flatdb_ingest import create_setdb_from_flatdb
        db = create_setdb_from_flatdb(inputs[0])
        if out_path is not None:
            db.save(out_path)
        return db
    files = expand_inputs(inputs, file_include, file_exclude)
    if not files:
        raise ValueError("no input files after expansion")
    is_nucl = any(f.endswith((".fna", ".fa", ".fasta")) and _looks_nucl(f)
                  for f in files[:1])
    if gff_dir is not None or is_nucl:
        raise NotImplementedError(
            "nucleotide (GFF) input is not ported yet (ROADMAP A11b)")
    db = create_setdb_from_fastas(files)
    if out_path is not None:
        db.save(out_path)
    return db


def _looks_nucl(path: str, sample: int = 500) -> bool:
    """createdb's nucleotide sniffing: >90% ACGTUN in the first sequence
    (createdb.cpp:540-573)."""
    seq = []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if seq:
                    break
                continue
            seq.append(line.strip())
            if sum(len(s) for s in seq) > sample:
                break
    s = "".join(seq).upper()
    if not s:
        return False
    frac = sum(1 for c in s if c in "AGCUNT") / len(s)
    return frac > 0.9
