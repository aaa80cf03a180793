"""GFF3 + contig-FASTA ingestion: createsetdb's nucleotide path.

Mirrors gff2db (src/workflow/gff2db.cpp:13-211) + translatenucs
(lib/mmseqs/src/util/translatenucs.cpp):

  * per GFF file (= one genome set), features filtered by type (default
    "CDS"), in file order
  * CDS region cut from the contig sequence [start-1, end); minus strand
    reverse-complemented via the IUPAC table
  * entry name "{contigName}_{featureIdx}_{start}_{end}" with start/end
    swapped on minus strand (gff2db.cpp:151-155)
  * set id = GFF file index; .source = GFF file basename (gff2db.cpp:39-49)
  * nucleotide genes translated to amino acids (table 1 by default)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import encode_aa, reverse_complement
from .fasta import iter_fasta
from .setdb import SetDB, DBTYPE_AMINO_ACIDS
from .translate import translate


def create_setdb_from_gff(gff_paths: list[str | Path],
                          fna_paths: list[str | Path],
                          gff_type: str = "CDS",
                          translation_table: int = 1) -> SetDB:
    """Build an amino-acid SetDB from per-genome GFF3 + contig FASTA files.

    `fna_paths` contains the contig FASTA files (any grouping); contigs are
    located by accession (first header token), as the reference resolves GFF
    seqid against the createdb lookup (gff2db.cpp:124-135).
    """
    features = [f for f in gff_type.split(",") if f]

    # contig accession -> sequence bytes
    contigs: dict[str, bytes] = {}
    for p in fna_paths:
        for header, seq in iter_fasta(p):
            acc = header.split()[0] if header.split() else header
            contigs[acc] = seq.encode("ascii")

    seq_parts: list[np.ndarray] = []
    names: list[str] = []
    headers: list[str] = []
    set_ids: list[int] = []
    sources: list[str] = []
    offsets = [0]

    for set_id, gff_path in enumerate(gff_paths):
        gff_path = Path(gff_path)
        sources.append(gff_path.name)
        idx = 0
        with open(gff_path) as fh:
            for line in fh:
                if line.startswith("#") or line == "\n":
                    continue
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 9:
                    continue
                if features and cols[2] not in features:
                    continue
                start = int(cols[3])
                end = int(cols[4])
                if start == end:
                    continue
                strand = cols[6]
                name = cols[0]
                if name not in contigs:
                    raise KeyError(f"GFF entry not found in contigs: {name}")
                nt = contigs[name][start - 1:end]
                if strand == "+":
                    entry_name = f"{name}_{idx}_{start}_{end}"
                else:
                    entry_name = f"{name}_{idx}_{end}_{start}"
                    nt = reverse_complement(nt)
                aa = translate(nt, translation_table)
                if len(aa) == 0:
                    # translatenucs skips len<3 entries (translatenucs.cpp:77-80)
                    idx += 1
                    continue
                names.append(entry_name)
                headers.append(entry_name)
                set_ids.append(set_id)
                enc = encode_aa(aa)
                seq_parts.append(enc)
                offsets.append(offsets[-1] + len(enc))
                idx += 1

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
    db.finalize_metadata()
    return db


def ingest_digest(db) -> dict:
    """Gene and residue counts and the sha256 of a SetDB's residues, gene
    offsets (int64), names and set ids (int32): what an ingest decides.
    Takes any object with those attributes, the JAX package's SetDB too."""
    import hashlib
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(db.seq_data, dtype=np.uint8).tobytes())
    h.update(np.ascontiguousarray(db.offsets, dtype="<i8").tobytes())
    h.update("\n".join(db.names).encode())
    h.update(np.ascontiguousarray(db.set_ids, dtype="<i4").tobytes())
    return {"genes": int(len(db.offsets) - 1),
            "residues": int(len(db.seq_data)), "sha256": h.hexdigest()}
