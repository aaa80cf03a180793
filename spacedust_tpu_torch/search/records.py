"""Alignment-result records and their canonical serialization.

Column order and formatting follow Matcher::resultToBuffer
(lib/mmseqs/src/alignment/Matcher.cpp:280-327):
  target score seqId eval qStart qEnd qLen tStart tEnd tLen [cigar]
with seqId via fastSeqIdToBuffer and eval via %.3E.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stats.fmt import fmt_double_3e, fmt_seq_id


@dataclass
class AlnRecord:
    tkey: int
    score: int          # integer bit score
    seq_id: float       # float32 semantics
    evalue: float
    qstart: int
    qend: int
    qlen: int
    tstart: int
    tend: int
    tlen: int
    backtrace: str = ""  # expanded ops "MMIID..."; serialized compressed
    raw_score: int = 0   # raw SW score (not serialized; kept for stats)
    qcov: float = 0.0
    tcov: float = 0.0
    cigar: str | None = None  # precompressed backtrace (native emission)

    def columns(self, add_backtrace: bool = True) -> list[str]:
        cols = [str(self.tkey), str(self.score), fmt_seq_id(self.seq_id),
                fmt_double_3e(self.evalue), str(self.qstart), str(self.qend),
                str(self.qlen), str(self.tstart), str(self.tend), str(self.tlen)]
        if add_backtrace:
            cols.append(self.cigar if self.cigar is not None
                        else compress_cigar(self.backtrace))
        return cols

    def line(self, add_backtrace: bool = True) -> str:
        return "\t".join(self.columns(add_backtrace))

    @classmethod
    def parse(cls, line: str) -> "AlnRecord":
        c = line.split("\t")
        return cls(tkey=int(c[0]), score=int(c[1]), seq_id=float(c[2]),
                   evalue=float(c[3]), qstart=int(c[4]), qend=int(c[5]),
                   qlen=int(c[6]), tstart=int(c[7]), tend=int(c[8]),
                   tlen=int(c[9]), backtrace=c[10] if len(c) > 10 else "")


def compress_cigar(backtrace: str) -> str:
    """Matcher::compressAlignment: run-length encode M/I/D ops."""
    if not backtrace:
        return ""
    out = []
    prev = backtrace[0]
    run = 1
    for ch in backtrace[1:]:
        if ch == prev:
            run += 1
        else:
            out.append(f"{run}{prev}")
            prev, run = ch, 1
    out.append(f"{run}{prev}")
    return "".join(out)


def expand_cigar(cigar: str) -> str:
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append(ch * int(num))
            num = ""
    return "".join(out)
