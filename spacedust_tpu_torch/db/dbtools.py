"""Generic flat-DB module transforms (the reference's L3 utility commands).

Each function is the in-memory equivalent of one MMseqs2 DB->DB module
command used by spacedust's workflows (SURVEY §2.2 "module commands";
lib/mmseqs/src/util/). They operate on `{key: text}` maps (one entry =
newline-separated lines) and interoperate with on-disk flat DBs via
`mmseqs_io.FlatDB` / `mmseqs_io.write_flatdb`, so users can mix our
stages with the reference's tooling over the same artifacts.

Covered commands and their reference sources:
  * tsv2db            (util/tsv2db.cpp:1-77)
  * result2stats      (util/result2stats.cpp, --stat linecount/sum/mean)
  * prefixid          (util/prefixid.cpp:1-97, incl. --tsv)
  * filterdb          (util/filterdb.cpp: --trim-to-one-column,
                       --extract-lines, --filter-column + --filter-regex)
  * swapdb            (util/swapresults.cpp: invert query->target map)
  * concatdbs         (util/mergedbs.cpp concat mode / concatdbs:
                       --preserve-keys)
  * mergedbs          (util/mergedbs.cpp: join entries per key)
  * subtractdbs       (util/subtractdbs.cpp: remove left keys present in
                       right, or per-line result subtraction by E-value)
  * createsubdb       (util/createsubdb.cpp: key-subset extraction)
  * renamedbkeys      (util/renamedbkeys.cpp: key remapping)
  * mergeresultsbyset (src/util/mergeresultsbyset.cpp via mapping DB)
"""

from __future__ import annotations

import re

DBMap = dict[int, str]


def _lines(text: str) -> list[str]:
    return [ln for ln in text.split("\n") if ln]


def tsv2db(tsv_text: str) -> DBMap:
    """First TSV column = key; remaining columns become entry lines
    grouped by consecutive key runs (tsv2db.cpp groups adjacent lines)."""
    out: DBMap = {}
    for line in _lines(tsv_text):
        key_s, _, rest = line.partition("\t")
        key = int(key_s)
        out[key] = out.get(key, "") + rest + "\n"
    return out


def result2stats(db: DBMap, stat: str = "linecount") -> DBMap:
    """--stat linecount | sum | mean over the first column
    (result2stats.cpp; spacedust uses linecount for _set_size)."""
    out: DBMap = {}
    for key, text in db.items():
        lines = _lines(text)
        if stat == "linecount":
            val = str(len(lines))
        elif stat in ("sum", "mean"):
            vals = [float(ln.split("\t")[0]) for ln in lines]
            total = sum(vals)
            val = (f"{total / len(vals)}" if stat == "mean" and vals
                   else f"{total}")
        else:
            raise ValueError(f"unsupported --stat {stat}")
        out[key] = val + "\n"
    return out


def prefixid(db: DBMap, as_tsv: bool = False,
             mapping: dict[int, str] | None = None) -> DBMap | str:
    """Prefix each entry line with its key (or its mapped name). With
    as_tsv, return the concatenated TSV text instead (prefixid.cpp --tsv)."""
    pieces: DBMap = {}
    for key, text in db.items():
        name = mapping[key] if mapping is not None else str(key)
        pieces[key] = "".join(f"{name}\t{ln}\n" for ln in _lines(text))
    if as_tsv:
        return "".join(pieces[k] for k in sorted(pieces))
    return pieces


def filterdb(db: DBMap, trim_to_one_column: bool = False,
             extract_lines: int = 0, filter_column: int = 0,
             filter_regex: str | None = None,
             filter_expression: str | None = None,
             positive_filter: bool = True) -> DBMap:
    """filterdb.cpp modes used by the workflows: --trim-to-one-column
    (keep first TAB field per line), --extract-lines N (first N lines),
    --filter-column C --filter-regex R (keep lines whose 1-based column C
    matches R; negate with positive_filter=False), --filter-expression E
    (tinyexpr analog with $N column variables; keep when E != 0,
    filterdb.cpp:357-372)."""
    rx = re.compile(filter_regex) if filter_regex else None
    expr = None
    if filter_expression is not None:
        from ..utils.expr import FilterExpression
        expr = FilterExpression(filter_expression)
    out: DBMap = {}
    for key, text in db.items():
        lines = _lines(text)
        if expr is not None:
            lines = [ln for ln in lines
                     if expr.evaluate(ln.split("\t")) != 0.0]
        if rx is not None:
            kept = []
            for ln in lines:
                col = ln.split("\t")[filter_column - 1]
                if bool(rx.search(col)) == positive_filter:
                    kept.append(ln)
            lines = kept
        if extract_lines > 0:
            lines = lines[:extract_lines]
        if trim_to_one_column:
            lines = [ln.split("\t")[0] for ln in lines]
        out[key] = "".join(ln + "\n" for ln in lines)
    return out


def swapdb(db: DBMap) -> DBMap:
    """Invert a result DB: output key = first column of each input line,
    entry lines = original key + remaining columns (swapresults.cpp).
    Output keys sorted; lines preserve input entry order."""
    out: dict[int, list[str]] = {}
    for key in sorted(db):
        for ln in _lines(db[key]):
            tkey_s, _, rest = ln.partition("\t")
            swapped = str(key) + ("\t" + rest if rest else "")
            out.setdefault(int(tkey_s), []).append(swapped)
    return {k: "".join(ln + "\n" for ln in v)
            for k, v in sorted(out.items())}


def concatdbs(a: DBMap, b: DBMap, preserve_keys: bool = True) -> DBMap:
    """Concatenate two DBs. With preserve_keys (spacedust's usage,
    data/clustersearch.sh:104), keys must be disjoint or identical-keyed
    entries are joined; without, b is re-keyed after a."""
    if preserve_keys:
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, "") + v
        return out
    out = dict(enumerate(a[k] for k in sorted(a)))
    base = len(out)
    for i, k in enumerate(sorted(b)):
        out[base + i] = b[k]
    return out


def mergedbs(dbs: list[DBMap]) -> DBMap:
    """Join entries per key across DBs in order (mergedbs.cpp; used by the
    iterative-search merge of per-round results)."""
    keys = sorted({k for db in dbs for k in db})
    return {k: "".join(db.get(k, "") for db in dbs) for k in keys}


def subtractdbs(left: DBMap, right: DBMap,
                eval_thr: float | None = None) -> DBMap:
    """Remove from `left` the result lines present in `right` by target
    key (subtractdbs.cpp; the iterative search subtracts previously
    accepted hits). With eval_thr, only right-lines with E-value <= thr
    mask (the reference's --e-profile semantics)."""
    out: DBMap = {}
    for key, text in left.items():
        mask: set[str] = set()
        for ln in _lines(right.get(key, "")):
            cols = ln.split("\t")
            if eval_thr is not None and len(cols) > 3:
                try:
                    if float(cols[3]) > eval_thr:
                        continue
                except ValueError:
                    pass
            mask.add(cols[0])
        kept = [ln for ln in _lines(text) if ln.split("\t")[0] not in mask]
        out[key] = "".join(ln + "\n" for ln in kept)
    return out


def createsubdb(db: DBMap, keys: list[int]) -> DBMap:
    """Key-subset extraction (createsubdb.cpp)."""
    return {k: db[k] for k in keys if k in db}


def renamedbkeys(db: DBMap, mapping: dict[int, int]) -> DBMap:
    """Remap keys old->new (renamedbkeys.cpp)."""
    return {mapping[k]: v for k, v in db.items() if k in mapping}


def mergeresultsbyset(db: DBMap, set_to_member: dict[int, list[int]]) -> DBMap:
    """Per set, concatenate the member entries in member order
    (src/util/mergeresultsbyset.cpp:1-71)."""
    return {s: "".join(db.get(m, "") for m in members)
            for s, members in set_to_member.items()}
