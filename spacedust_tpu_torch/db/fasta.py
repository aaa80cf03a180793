"""FASTA ingestion: createsetdb's amino-acid path.

Mirrors `createdb` + the lookup rewrite of data/createsetdb.sh:113-141:
  * entries read per file in order; set id = file index
  * entry accession = first whitespace-delimited token of the header
    (Util::parseFastaHeader)
  * Prodigal headers "acc # start # end # strand # ..." provide CDS
    coordinates; strand == -1 swaps start/end in the entry name
  * per-set gene counter (0-based, file order) becomes posIdx
  * final entry name: "{acc}_{posIdx}_{start}_{end}"
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from ..constants import encode_aa
from .setdb import SetDB, DBTYPE_AMINO_ACIDS


def _open_maybe_compressed(path: str | Path):
    """Open FASTA/FASTQ text transparently handling gzip and bzip2 by
    magic-byte sniffing (KSeqWrapper parity: the reference reads plain,
    .gz and .bz2 inputs, commons/KSeqWrapper.cpp)."""
    with open(path, "rb") as probe:
        magic = probe.read(3)
    if magic[:2] == b"\x1f\x8b":
        import gzip
        return gzip.open(path, "rt")
    if magic == b"BZh":
        import bz2
        return bz2.open(path, "rt")
    return open(path)


def iter_fasta(path: str | Path) -> Iterator[tuple[str, str]]:
    """Yield (header_without_marker, sequence) preserving file order.

    Accepts FASTA ('>' records) and FASTQ ('@' records; the '+' quality
    section is skipped), plain or gzip/bzip2-compressed — the same input
    surface as the reference's KSeqWrapper (commons/KSeqWrapper.cpp)."""
    header = None
    chunks: list[str] = []
    qual_left = -1          # >=0: consuming FASTQ quality characters
    with _open_maybe_compressed(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if qual_left > 0:
                qual_left -= len(line.strip())
                continue
            if line.startswith(">") or line.startswith("@"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
                qual_left = -1
            elif line.startswith("+") and header is not None:
                # FASTQ separator: quality section is as long as the seq
                qual_left = sum(len(c) for c in chunks)
            elif line:
                chunks.append(line.strip())
    if header is not None:
        yield header, "".join(chunks)


def parse_prodigal_header(header: str) -> tuple[str, int, int, int]:
    """Return (accession, start, end, strand) from a Prodigal-style header.

    The shell pipeline removes ALL spaces then splits on '#'
    (createsetdb.sh:119-124), so any "acc # start # end # strand # ..."
    form parses the same way.
    """
    squashed = header.replace(" ", "")
    fields = squashed.split("#")
    acc = fields[0]
    start = int(fields[1])
    end = int(fields[2])
    strand = int(fields[3])
    return acc, start, end, strand


def create_setdb_from_fastas(paths: list[str | Path]) -> SetDB:
    seq_parts: list[np.ndarray] = []
    names: list[str] = []
    headers: list[str] = []
    set_ids: list[int] = []
    sources: list[str] = []
    offsets = [0]

    for set_id, path in enumerate(paths):
        path = Path(path)
        sources.append(path.name)
        counter = 0
        for header, seq in iter_fasta(path):
            acc, start, end, strand = parse_prodigal_header(header)
            if strand == -1:
                start, end = end, start
            names.append(f"{acc}_{counter}_{start}_{end}")
            headers.append(header)
            set_ids.append(set_id)
            enc = encode_aa(seq)
            seq_parts.append(enc)
            offsets.append(offsets[-1] + len(enc))
            counter += 1

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
