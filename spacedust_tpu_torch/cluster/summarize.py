"""Final TSV rendering (summarizeresults equivalent).

Mirrors src/util/SummarizeResults.cpp:60-117: per cluster a
  "#<clusterID>\t<qSource>\t<tSource>\t<pCO>\t<pMH>\t<nHits>"
summary line followed by
  ">**<qName>\t<tName>\t<pval seqId eval qs qe ql ts te tl cigar>"
hit lines with lookup entry names substituted for numeric keys.
"""

from __future__ import annotations

from ..db.setdb import SetDB
from .clusterhits import Cluster


def summarize_results(clusters: list[Cluster],
                      query_db: SetDB,
                      target_db: SetDB) -> str:
    out: list[str] = []
    for cluster_id, cl in enumerate(clusters):
        out.append("#" + "\t".join([
            str(cluster_id),
            query_db.sources[cl.qset],
            target_db.sources[cl.tset],
            cl.header.split("\t")[2],   # pCO as formatted
            cl.header.split("\t")[3],   # pMH as formatted
            str(len(cl.hits)),
        ]) + "\n")
        for h in cl.hits:
            cols = h.line.rstrip("\n").split("\t")
            qname = query_db.names[int(cols[0])]
            tname = target_db.names[int(cols[1])]
            out.append(">" + "\t".join([qname, tname] + cols[2:]) + "\n")
    return "".join(out)


def seq_to_clu(clusters: list[Cluster]) -> dict[int, list[int]]:
    """swapdb(filterdb --trim-to-one-column) equivalent: gene key ->
    cluster ids (clustersearch.sh:157-164)."""
    mapping: dict[int, list[int]] = {}
    for cluster_id, cl in enumerate(clusters):
        for h in cl.hits:
            qkey = int(h.line.split("\t", 1)[0])
            mapping.setdefault(qkey, []).append(cluster_id)
    return mapping


def canonical_blocks(tsv: str) -> list[tuple[str, tuple[str, ...]]]:
    """The result TSV as a sorted list of (cluster header without its id,
    sorted hit lines): cluster ids follow thread order in the reference,
    so two results are compared as sets of blocks."""
    blocks, cur = [], None
    for ln in tsv.splitlines():
        if ln.startswith("#"):
            if cur:
                blocks.append((cur[0], tuple(sorted(cur[1]))))
            cur = ("\t".join(ln.split("\t")[1:]), [])
        else:
            cur[1].append(ln)
    if cur:
        blocks.append((cur[0], tuple(sorted(cur[1]))))
    return sorted(blocks)


def canonical_sha256(tsv: str) -> str:
    """sha256 of the canonical block form of a result TSV."""
    import hashlib
    text = "".join("#" + head + "\n" + "".join(h + "\n" for h in hits)
                   for head, hits in canonical_blocks(tsv))
    return hashlib.sha256(text.encode()).hexdigest()
