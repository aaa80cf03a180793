"""Ingest a pre-built MMseqs2/Foldseek flat DB as a SetDB.

The reference's createsetdb accepts an existing DB (e.g.
examples/foldseek_testdb/foldseek_test, with its _h headers, .lookup,
.source and _ss 3Di sidecars) and only rewrites the lookup metadata
(data/createsetdb.sh:51-77,109-141, "external" path):

  * headers are Prodigal-style "acc # start # end # strand # ...";
    strand == -1 swaps start/end in the entry name
  * entries are version-sorted by accession (`sort -k2,2 -V`) to restore
    genome order, a per-set counter in that order becomes posIdx
  * final entry name: "{acc}_{posIdx}_{start}_{end}"; set id = the
    lookup fileNumber
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ..constants import encode_aa
from .fasta import parse_prodigal_header
from .mmseqs_io import FlatDB, read_lookup
from .setdb import SetDB, DBTYPE_AMINO_ACIDS


def _version_key(name: str):
    """GNU `sort -V` ordering key: digit runs compare numerically."""
    return [int(p) if p.isdigit() else p
            for p in re.split(r"(\d+)", name)]


def create_setdb_from_flatdb(base: str | Path) -> SetDB:
    base = Path(base)
    seq_db = FlatDB.open(base)
    hdr_db = FlatDB.open(f"{base}_h")
    lookup = read_lookup(base)

    sources: list[str] = []
    src_path = Path(f"{base}.source")
    if src_path.exists():
        by_id = {}
        for line in src_path.read_text().splitlines():
            sid, fname = line.split("\t")
            by_id[int(sid)] = fname
        sources = [by_id[i] for i in sorted(by_id)]
    else:
        n_sets = max(fileno for _k, _n, fileno in lookup) + 1
        sources = [f"set{i}" for i in range(n_sets)]

    # header-derived coordinates per key
    coords: dict[int, tuple[str, int, int]] = {}
    for key, _name, _fileno in lookup:
        header = hdr_db.get(key).strip()
        acc, start, end, strand = parse_prodigal_header(header)
        if strand == -1:
            start, end = end, start
        coords[key] = (acc, start, end)

    # version-sort by accession, per-set counter -> posIdx
    order = sorted(lookup, key=lambda kv: _version_key(coords[kv[0]][0]))
    names_by_key: dict[int, str] = {}
    prev_set = None
    counter = 0
    for key, _name, fileno in order:
        counter = counter + 1 if fileno == prev_set else 1
        prev_set = fileno
        acc, start, end = coords[key]
        names_by_key[key] = f"{acc}_{counter - 1}_{start}_{end}"

    ss_db = None
    if Path(f"{base}_ss.dbtype").exists() or Path(f"{base}_ss.index").exists():
        ss_db = FlatDB.open(f"{base}_ss")

    keys = sorted(k for k, _n, _f in lookup)
    set_of = {k: f for k, _n, f in lookup}
    seq_parts, ss_parts = [], []
    names, headers, set_ids = [], [], []
    offsets = [0]
    for key in keys:
        seq = seq_db.get(key).strip()
        enc = encode_aa(seq)
        seq_parts.append(enc)
        offsets.append(offsets[-1] + len(enc))
        names.append(names_by_key[key])
        headers.append(hdr_db.get(key).strip())
        set_ids.append(set_of[key])
        if ss_db is not None:
            ss = ss_db.get(key).strip()
            if len(ss) != len(seq):
                raise ValueError(
                    f"_ss length mismatch for key {key}: {len(ss)} != {len(seq)}")
            ss_parts.append(encode_aa(ss))

    db = SetDB(
        dbtype=DBTYPE_AMINO_ACIDS,
        seq_data=(np.concatenate(seq_parts) if seq_parts
                  else np.empty(0, dtype=np.uint8)),
        offsets=np.asarray(offsets, dtype=np.int64),
        names=names,
        set_ids=np.asarray(set_ids, dtype=np.int32),
        headers=headers,
        sources=sources,
    )
    if ss_parts:
        db.ss_data = np.concatenate(ss_parts)
    db.finalize_metadata()
    return db
