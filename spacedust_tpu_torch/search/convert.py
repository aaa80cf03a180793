"""convertalignments: export alignment records as BLAST-tab (m8) text.

Equivalent of the reference's convertalignments module
(lib/mmseqs/src/util/convertalignments.cpp:400-465). Default column set
  query target fident alnlen mismatch gapopen qstart qend tstart tend
  evalue bits
with the reference's exact derivations:
  * alnlen / matchCount / gapOpenCount from the compressed CIGAR:
    alnlen = sum of all run lengths, matchCount = sum of 'M' runs, each
    'I'/'D' run counts one gap open (convertalignments.cpp:417-439)
  * identical = round(seqId * alnlen); mismatch = matchCount - identical
    (convertalignments.cpp:441-443); without a backtrace, mismatch is
    estimated as round(min(qSpan, tSpan) * (1 - seqId))
    (convertalignments.cpp:445-450)
  * coordinates 1-based (qstart+1 ...), fident "%1.3f", evalue "%.2E",
    bits = the stored bit score (convertalignments.cpp:454-461)

Custom --format-output codes (a subset of the reference's outcodes,
convertalignments.cpp:66-97) are supported via `format_output`.
"""

from __future__ import annotations

import re

from .records import AlnRecord, compress_cigar

DEFAULT_FORMAT = ("query,target,fident,alnlen,mismatch,gapopen,"
                  "qstart,qend,tstart,tend,evalue,bits")

_CIGAR_RE = re.compile(r"(\d+)([MID])")


def _cigar_stats(cigar: str) -> tuple[int, int, int]:
    """(alnlen, matchCount, gapOpenCount) from a compressed CIGAR."""
    alnlen = match = gapopen = 0
    for cnt, op in _CIGAR_RE.findall(cigar):
        n = int(cnt)
        alnlen += n
        if op == "M":
            match += n
        else:
            gapopen += 1
    return alnlen, match, gapopen


def record_fields(rec: AlnRecord, qname: str, tname: str) -> dict[str, str]:
    cigar = rec.backtrace
    if cigar and not cigar[0].isdigit():
        cigar = compress_cigar(cigar)
    if cigar:
        alnlen, match_count, gapopen = _cigar_stats(cigar)
        identical = int(rec.seq_id * float(alnlen) + 0.5)
        mismatch = match_count - identical
    else:
        alnlen = rec.qend - rec.qstart + 1  # res.alnLength fallback
        gapopen = 0
        best_match = float(min(abs(rec.qend - max(rec.qstart, 0)),
                               abs(rec.tend - max(rec.tstart, 0))))
        identical = int(rec.seq_id * best_match + 0.5)
        mismatch = int(best_match * (1.0 - rec.seq_id) + 0.5)
    return {
        "query": qname,
        "target": tname,
        "fident": f"{rec.seq_id:1.3f}",
        "pident": f"{rec.seq_id * 100.0:1.3f}",
        "nident": str(identical),
        "alnlen": str(alnlen),
        "mismatch": str(mismatch),
        "gapopen": str(gapopen),
        "qstart": str(rec.qstart + 1),
        "qend": str(rec.qend + 1),
        "qlen": str(rec.qlen),
        "tstart": str(rec.tstart + 1),
        "tend": str(rec.tend + 1),
        "tlen": str(rec.tlen),
        "evalue": f"{rec.evalue:.2E}",
        "bits": str(rec.score),
        "raw": str(rec.raw_score),
        "cigar": cigar,
        "qcov": f"{rec.qcov:1.3f}",
        "tcov": f"{rec.tcov:1.3f}",
    }


def convert_alignments(records: dict[int, list[AlnRecord]],
                       query_names: dict[int, str] | list[str],
                       target_names: dict[int, str] | list[str],
                       format_output: str = DEFAULT_FORMAT) -> str:
    """Render an alignment result map {query_key: [AlnRecord]} as m8 text.

    `query_names` / `target_names`: key -> displayed accession (for a
    SetDB, its `names` list; the reference uses Util::parseFastaHeader of
    the _h DBs, convertalignments.cpp:409-412)."""
    cols = [c.strip() for c in format_output.split(",") if c.strip()]
    unknown = [c for c in cols if c not in _KNOWN_CODES]
    if unknown:
        raise ValueError(f"unknown --format-output codes: {unknown}")
    out: list[str] = []
    for qkey in sorted(records):
        qname = query_names[qkey]
        for rec in records[qkey]:
            f = record_fields(rec, qname, target_names[rec.tkey])
            out.append("\t".join(f[c] for c in cols))
    return "\n".join(out) + ("\n" if out else "")


_KNOWN_CODES = {
    "query", "target", "fident", "pident", "nident", "alnlen", "mismatch",
    "gapopen", "qstart", "qend", "qlen", "tstart", "tend", "tlen",
    "evalue", "bits", "raw", "cigar", "qcov", "tcov",
}
