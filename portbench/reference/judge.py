"""The comparison that decides `correct`: a job's outputs against the plain
reference and against what the generator planted.

It reads the program's outputs only to judge them: the cluster TSV and
the search result DB (`result` in the clustersearch tmp dir, one MMseqs2
alignment record a line: target, bit score, identity, E-value, query
start, end, length, target start, end, length, CIGAR).  Everything else
it works out again from the generated sequences.  The numbers:

  * sw_wrong: alignment records (every non-self record, or a sample
    drawn from the seed that holds the longest pairs, and every record
    that competes with a TSV hit for its query's best hit) whose bit score,
    query start or end, or target start or end differ from the plain
    reference's SW (reference/sw.py) of the pair.  Exact: limit 0.
  * traceback_wrong: of the same records, those whose E-value (beyond the
    rounding of its printed digits; scoring.evalues) or query or target
    length differ from the reference's, and, of a sample of them drawn
    from the seed that holds the longest pairs, those whose CIGAR (so
    also the alignment length) or identity column differ from the plain
    reference's banded traceback (reference/traceback.py) of the pair in
    the reference's own rectangle.  Exact: limit 0.
  * hits_unbacked: hit lines of the TSV that are not, column for column,
    a record of the search.  Exact: limit 0.
  * hits_not_best: hit lines of the TSV whose target is not its query's
    best hit in the target's genome: another record of the query there
    has a lower E-value by the reference (each rounded as printed), the
    rule by which the tail picks a hit.  Exact: limit 0.
  * pairs_missed: the share of the planted cross-genome homolog pairs that
    a sound search finds (identity and length over the traffic's floor)
    with no record in either direction.  In a collection (more than two
    genomes) these are the pairs of genes, in any two genomes, that
    descend from one gene of the source pair or from one planted pair.
  * blocks_missed: the share of the planted conserved blocks of which no
    cluster of the TSV holds two pairs or more.  In a collection a
    planted block counts once in each pair of genomes, one from each
    source's line, that keeps two or more of its pairs.
  * jobs_differ: jobs of the window whose TSV or search result differ from
    the last job's (every job has the same input).  Exact: limit 0.
  * output_missing: 1 where the last job left no TSV or no result DB.
"""

from __future__ import annotations

import bisect
import string
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import scoring
from .sw import Pairs, align
from .traceback import cigar, traceback


@dataclass
class JobOutputs:
    tsv: str | None
    records: dict | None        # {(qkey, tkey): [columns]}

    @classmethod
    def read(cls, tsv_path: Path, tmp_dir: Path) -> "JobOutputs":
        tsv = tsv_path.read_text() if tsv_path.exists() else None
        found = sorted(tmp_dir.glob("*/result")) if tmp_dir.exists() else []
        return cls(tsv, read_records(found[0]) if found else None)


def read_records(base: Path) -> dict:
    """{(qkey, tkey): columns} of an MMseqs2 flat alignment DB."""
    data = base.read_bytes()
    out = {}
    for line in Path(f"{base}.index").read_text().splitlines():
        k, off, n = (int(x) for x in line.split("\t"))
        for row in data[off:off + n].rstrip(b"\x00").decode().splitlines():
            if row:
                cols = row.split("\t")
                out[(k, int(cols[0]))] = cols
    return out


class Inputs:
    """The cell's inputs as the generator made them: genomes (lists of
    [protein, strand(, 3Di)]), its Truth, the search kind and gaps."""

    def __init__(self, genomes, truth, kind: str, gap_open: int,
                 gap_extend: int):
        self.genomes, self.truth, self.kind = genomes, truth, kind
        self.gap_open, self.gap_extend = gap_open, gap_extend
        # the key of each genome's first gene: genomes follow one another
        self.first = np.cumsum([0] + [len(g) for g in genomes]).tolist()
        self.genes = [g for genome in genomes for g in genome]
        self.residues = sum(len(g[0]) for g in self.genes)
        self._bias: dict[int, np.ndarray] = {}
        self._memo: dict = {}

    def key(self, gi: int, i: int) -> int:
        return self.first[gi] + i

    def genome(self, k: int) -> int:
        return bisect.bisect_right(self.first, k) - 1

    def key_of_name(self, name: str) -> int:
        """A TSV gene name `SYN<A|B|C...>_000001.1_<i>_...` (i from 1; the
        contig's letter is its genome's, gen/synth.py::contig)."""
        parts = name.split("_")
        return self.key(string.ascii_uppercase.index(parts[0][-1]),
                        int(parts[2]) - 1)

    def bias(self, k: int) -> np.ndarray:
        if k not in self._bias:
            if self.kind == "seq":
                sub, p = scoring.blosum62()
                self._bias[k] = scoring.comp_bias(
                    self.genes[k][0].astype(np.int64), sub, p)
            else:
                m3, p3, _aa, _lam = scoring.struct_tables()
                self._bias[k] = scoring.comp_bias(
                    self.genes[k][2].astype(np.int64), m3, p3)
        return self._bias[k]

    def pairs(self, keys) -> Pairs:
        g = self.genes
        qb = [self.bias(q).astype(np.int64) for q, _t in keys]
        if self.kind == "seq":
            return Pairs([g[q][0].astype(np.int64) for q, _t in keys], qb,
                         [g[t][0].astype(np.int64) for _q, t in keys],
                         scoring.blosum62()[0])
        m3, _p3, aa, _lam = scoring.struct_tables()
        return Pairs([g[q][2].astype(np.int64) for q, _t in keys], qb,
                     [g[t][2].astype(np.int64) for _q, t in keys], m3,
                     q2=[g[q][0].astype(np.int64) for q, _t in keys],
                     t2=[g[t][0].astype(np.int64) for _q, t in keys],
                     sub2=aa)


def sample_keys(records, inputs: Inputs, seed: int, limit: int,
                longest: int) -> list:
    """The non-self keys of `records`, or over `limit`, the `longest` by
    cells and the rest drawn from the seed."""
    keys = sorted(k for k in records if k[0] != k[1])
    if len(keys) <= limit:
        return keys
    size = np.array([len(inputs.genes[q][0]) * len(inputs.genes[t][0])
                     for q, t in keys], dtype=np.int64)
    top = set(np.argsort(-size, kind="stable")[:longest].tolist())
    rest = np.array([i for i in range(len(keys)) if i not in top])
    pick = np.random.default_rng([seed, 17]).choice(
        rest, limit - len(top), replace=False)
    return [keys[i] for i in sorted(top | set(pick.tolist()))]


def reference(inputs: Inputs, keys: list, device, saturate=None) -> dict:
    """The reference's SW of each key: {key: (raw score, bits, q_start,
    q_end, t_start, t_end)}, kept on `inputs` for a second call."""
    memo = ("sw", tuple(keys), saturate)
    if memo not in inputs._memo:
        res = align(inputs.pairs(keys), inputs.gap_open, inputs.gap_extend,
                    device, saturate=saturate)
        bits = scoring.bit_scores(res["score"], inputs.kind)
        inputs._memo[memo] = {
            k: (int(res["score"][i]), int(bits[i]), int(res["q_start"][i]),
                int(res["q_end"][i]), int(res["t_start"][i]),
                int(res["t_end"][i])) for i, k in enumerate(keys)}
    return inputs._memo[memo]


def sw_answers(inputs: Inputs, keys: list, device, saturate=None) -> dict:
    """The reference's (bits, q_start, q_end, t_start, t_end) of each key."""
    ref = reference(inputs, keys, device, saturate)
    return {k: ref[k][1:] for k in keys}


def reference_columns(inputs: Inputs, keys: list, traced: list,
                      device) -> dict:
    """{key: (identity text, E-value, q_len, t_len, CIGAR)} of the keys the
    reference scores above 0: its E-value for each, and for the keys in
    `traced` its banded traceback in its own rectangle (identity and
    CIGAR None elsewhere, and where the traceback fails)."""
    memo = ("tb", tuple(keys), tuple(traced))
    if memo in inputs._memo:
        return inputs._memo[memo]
    ref = reference(inputs, keys, device)
    live = [k for k in keys if ref[k][0] > 0]
    raw = np.array([ref[k][0] for k in live], dtype=np.int64)
    qlen = np.array([len(inputs.genes[q][0]) for q, _t in live], np.int64)
    ev = scoring.evalues(raw, qlen, inputs.residues, inputs.kind)
    out = {(q, t): [None, float(ev[i]), int(qlen[i]),
                    len(inputs.genes[t][0]), None]
           for i, (q, t) in enumerate(live)}
    tr = [k for k in traced if k in out]
    arr = np.array([ref[k] for k in tr], dtype=np.int64).reshape(-1, 6)
    rect = {"score": arr[:, 0], "q_start": arr[:, 2], "q_end": arr[:, 3],
            "t_start": arr[:, 4], "t_end": arr[:, 5]}
    pairs = inputs.pairs(tr)
    ops, idents = traceback(pairs.q, pairs.qb, pairs.t, pairs.sub, rect,
                            inputs.gap_open, inputs.gap_extend, device,
                            q2=pairs.q2, t2=pairs.t2, sub2=pairs.sub2,
                            ident_q=pairs.q2, ident_t=pairs.t2)
    for i, k in enumerate(tr):
        if ops[i] is not None:
            out[k][0] = scoring.seq_id_text(int(idents[i]), len(ops[i]))
            out[k][4] = cigar(ops[i])
    inputs._memo[memo] = out
    return out


def evalue_as_printed(text: str, value: float) -> bool:
    """Whether the printed E-value `text` ("%.3E") is `value` rounded to
    its digits (with room for the last bits of a float64)."""
    printed = float(text)
    if printed == 0.0:
        return abs(value) < 1e-300
    half = 0.5 * 10.0 ** (int(text.split("E")[1]) - 3)
    return abs(printed - value) <= half * (1 + 1e-9)


def columns_differ(cols: list, ref, traced: bool) -> bool:
    """A record's E-value and lengths against the reference's, and where
    the record was traced, its identity and CIGAR (a failed traceback
    differs)."""
    if ref is None:
        return True
    ident, ev, qlen, tlen, cig = ref
    return (not evalue_as_printed(cols[3], ev)
            or int(cols[6]) != qlen or int(cols[9]) != tlen
            or (traced and (cig is None or cols[2] != ident
                            or (cols[10] if len(cols) > 10 else "") != cig)))


def program_answers(records: dict, keys: list) -> dict:
    return {k: tuple(int(records[k][c]) for c in (1, 4, 5, 7, 8))
            for k in keys}


def best_hit_keys(records: dict, hits: list, inputs: Inputs) -> list:
    """The records that compete with each TSV hit for its query's best
    hit in the target's genome (the query itself left out)."""
    want = {(q, inputs.genome(t)) for _c, q, t, _cols in hits}
    return [(q, t) for q, t in records
            if q != t and (q, inputs.genome(t)) in want]


def hits_not_best(records: dict, hits: list, inputs: Inputs,
                  cols: dict) -> int:
    """TSV hits that another record of their query in the target's genome
    beats on the reference's E-value, each rounded as printed."""
    best: dict = {}
    for (q, t) in best_hit_keys(records, hits, inputs):
        c = cols.get((q, t))
        if c is not None:
            e = float("%.3E" % c[1])
            g = (q, inputs.genome(t))
            best[g] = min(best.get(g, np.inf), e)
    bad = 0
    for _c, q, t, _cols in hits:
        c = cols.get((q, t))
        bad += (c is None
                or float("%.3E" % c[1]) > best.get((q, inputs.genome(t)),
                                                   np.inf))
    return bad


def tsv_hits(tsv: str, inputs: Inputs):
    """[(cluster index, qkey, tkey, columns)] of the TSV's hit lines."""
    out, c = [], -1
    for line in tsv.splitlines():
        if line.startswith("#"):
            c += 1
        elif line.startswith(">"):
            cols = line[1:].split("\t")
            out.append((c, inputs.key_of_name(cols[0]),
                        inputs.key_of_name(cols[1]), cols))
    return out


def judge(outputs: JobOutputs, digests: list, inputs: Inputs, params: dict,
          seed: int, device, control: bool = False) -> dict:
    """{name: value} of every number compared.  control=True judges the
    control: the reference computed in int8 (saturating) put in the
    program's place for the SW answers."""
    nums = {"output_missing": int(outputs.tsv is None
                                  or outputs.records is None)}
    last = digests[-1] if digests else None
    nums["jobs_differ"] = sum(d != last for d in digests)
    if nums["output_missing"]:
        nums.update(sw_wrong=0, sw_checked=0, traceback_wrong=0, tb_checked=0,
                    hits_unbacked=0, hits_not_best=0, pairs_missed=1.0,
                    blocks_missed=1.0)
        return nums
    records = outputs.records
    hits = tsv_hits(outputs.tsv, inputs)
    keys = sorted(set(sample_keys(records, inputs, seed, params["sample"],
                                  params["longest"]))
                  | set(best_hit_keys(records, hits, inputs)))
    ref = sw_answers(inputs, keys, device)
    got = (sw_answers(inputs, keys, device, saturate=8) if control
           else program_answers(records, keys))
    nums["sw_wrong"] = sum(got[k] != ref[k] for k in keys)
    nums["sw_checked"] = len(keys)
    traced = set(sample_keys(keys, inputs, seed, params["traceback_sample"],
                             params["longest"]))
    cols = reference_columns(inputs, keys, sorted(traced), device)
    nums["traceback_wrong"] = sum(
        columns_differ(records[k], cols.get(k), k in traced) for k in keys)
    nums["tb_checked"] = len(traced)

    nums["hits_unbacked"] = sum(
        records.get((q, t), [None] * 11)[2:11] != c[3:12]
        for _c, q, t, c in hits)
    nums["hits_not_best"] = hits_not_best(records, hits, inputs, cols)

    # each planted pair as its two keys
    pairs = [(inputs.key(ga, a), inputs.key(gb, b))
             for ga, a, gb, b, _i, _s in inputs.truth.pairs]
    ident_col = 4 if inputs.kind == "seq" else 5
    eligible = [k for k, p in zip(pairs, inputs.truth.pairs)
                if p[ident_col] >= params["pair_min_ident"]
                and min(len(inputs.genes[k[0]][0]),
                        len(inputs.genes[k[1]][0])) >= params["pair_min_len"]]
    missed = 0
    for ka, kb in eligible:
        missed += (ka, kb) not in records and (kb, ka) not in records
    nums["pairs_missed"] = missed / max(len(eligible), 1)

    clusters: dict[int, set] = {}
    for c, q, t, _cols in hits:
        clusters.setdefault(c, set()).add(frozenset((q, t)))
    blocks_missed = 0
    for block in inputs.truth.blocks:
        want = {frozenset(pairs[i]) for i in block}
        best = max((len(want & got_pairs) for got_pairs in clusters.values()),
                   default=0)
        blocks_missed += best < 2
    nums["blocks_missed"] = blocks_missed / max(len(inputs.truth.blocks), 1)
    return nums


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit."""
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return all(nums[k] <= limits[k] for k in limits), checks
