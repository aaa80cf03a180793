"""createsetdb workflow: FASTA/GFF inputs -> SetDB artifact.

Mirrors src/workflow/createsetdb.cpp:20-140: expands a directory or .tsv
list into file names (with --file-include/--file-exclude regex), then
dispatches to the amino-acid (Prodigal headers) or nucleotide (contigs
plus one GFF3 a genome, db/gff.py) path.  A single input with a
`.dbtype` file is a pre-built MMseqs2/Foldseek DB (with its `_ss` 3Di
sidecar, if any) and goes through db/flatdb_ingest.py.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..db.fasta import create_setdb_from_fastas
from ..db.gff import create_setdb_from_gff
from ..db.setdb import SetDB
from ..utils import trace


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
                 gff_type: str = "CDS",
                 translation_table: int = 1,
                 file_include: str = ".*",
                 file_exclude: str = "^$") -> SetDB:
    with trace.span("createsetdb.read"):
        db = _read_inputs(inputs, gff_dir, gff_type, translation_table,
                          file_include, file_exclude)
    if out_path is not None:
        with trace.span("createsetdb.write"):
            db.save(out_path)
    return db


def _read_inputs(inputs, gff_dir, gff_type, translation_table,
                 file_include, file_exclude) -> SetDB:
    # pre-built MMseqs2/Foldseek DB input (createsetdb.sh:51-77 "external"
    # path): copy sequences (+ _ss 3Di sidecar) and rewrite the lookup
    if len(inputs) == 1 and Path(f"{inputs[0]}.dbtype").exists():
        from ..db.flatdb_ingest import create_setdb_from_flatdb
        return create_setdb_from_flatdb(inputs[0])
    files = expand_inputs(inputs, file_include, file_exclude)
    if not files:
        raise ValueError("no input files after expansion")
    is_nucl = any(f.endswith((".fna", ".fa", ".fasta")) and _looks_nucl(f)
                  for f in files[:1])
    if gff_dir is not None:
        return create_setdb_from_gff(gff_files(gff_dir), files, gff_type,
                                     translation_table)
    if is_nucl:
        raise ValueError("nucleotide input requires --gff-dir")
    return create_setdb_from_fastas(files)


def gff_files(gff_dir: str) -> list[str]:
    """The GFF3 files of --gff-dir, a file listing one path a line (the
    reference's form, examples/gff.txt)."""
    return [ln.strip() for ln in Path(gff_dir).read_text().splitlines()
            if ln.strip()]


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
