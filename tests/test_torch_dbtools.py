"""The library tools of the port (ROADMAP A11b: db/orftools.py,
db/dbtools.py, utils/expr.py; neither package has a CLI for them) against
the JAX package on seeded inputs.  Equal, not close."""

import dataclasses

import numpy as np
import pytest

from spacedust_tpu.db import dbtools as jax_dbt
from spacedust_tpu.db import orftools as jax_orf
from spacedust_tpu.utils.expr import FilterExpression as JaxExpression
from spacedust_tpu_torch.db import dbtools as dbt
from spacedust_tpu_torch.db import orftools as orf
from spacedust_tpu_torch.utils.expr import FilterExpression


def contig(rng, n: int) -> str:
    """Random bases, some N runs, some lower case."""
    s = np.array(list("ACGT"))[rng.integers(0, 4, n)]
    for _ in range(3):
        p = int(rng.integers(0, n - 20))
        s[p:p + int(rng.integers(1, 12))] = "N"
    return "".join(s)


@pytest.mark.parametrize("seed", range(4))
def test_orfs_match_jax(seed):
    """find_orfs and extract_orfs (plain and translated) over the start
    modes, frames, length and gap limits, contig start / end modes and
    tables."""
    rng = np.random.default_rng(seed)
    seqs = {k: contig(rng, int(rng.integers(300, 3000))) for k in range(3)}
    seqs[1] = seqs[1].lower()
    for start_mode in (0, 1, 2):
        for table, all_starts in ((1, False), (11, True), (4, False)):
            kw = dict(min_length=int(rng.integers(10, 60)),
                      max_length=int(rng.integers(200, 2000)),
                      max_gaps=int(rng.integers(0, 3)) or 2147483647,
                      forward_frames={1, 2, 3} if seed % 2 else {1, 3},
                      reverse_frames={2} if seed % 2 else {1, 2, 3},
                      start_mode=start_mode, translation_table=table,
                      use_all_table_starts=all_starts)
            for s in seqs.values():
                assert ([dataclasses.astuple(x)
                         for x in orf.find_orfs(s, **kw)]
                        == [dataclasses.astuple(x)
                            for x in jax_orf.find_orfs(s, **kw)])
            for cs, ce in ((2, 2), (0, 1), (1, 0)):
                for tr in (False, True):
                    assert orf.extract_orfs(
                        seqs, translate_orfs=tr, contig_start_mode=cs,
                        contig_end_mode=ce, **kw) == jax_orf.extract_orfs(
                        seqs, translate_orfs=tr, contig_start_mode=cs,
                        contig_end_mode=ce, **kw)


def test_orf_headers_and_offsets_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        key, a, b = (int(x) for x in rng.integers(0, 5000, 3))
        inc = [bool(x) for x in rng.integers(0, 2, 2)]
        h = orf.write_orf_header(key, a, b, *inc)
        assert h == jax_orf.write_orf_header(key, a, b, *inc)
        assert orf.parse_orf_header(h) == jax_orf.parse_orf_header(h)
        cols = [str(int(x)) for x in rng.integers(0, 900, 10)]
        for nucl in (False, True):
            for target in (False, True):
                assert (orf.offset_alignment(cols, h, nucl, target)
                        == jax_orf.offset_alignment(cols, h, nucl, target))
    s = contig(rng, 500)
    assert orf.reverse_complement(s) == jax_orf.reverse_complement(s)


def random_db(rng, n_keys: int = 12) -> dict:
    """{key: lines}: result-like lines (target key, score, seq id,
    E-value, ...)."""
    db = {}
    for k in rng.permutation(40)[:n_keys].tolist():
        lines = []
        for _ in range(int(rng.integers(0, 6))):
            lines.append("\t".join([
                str(int(rng.integers(0, 30))), str(int(rng.integers(0, 500))),
                f"{rng.random():.3f}", f"{10.0 ** -rng.integers(0, 40):.3E}",
                "seq" + str(int(rng.integers(0, 9)))]))
        db[k] = "".join(ln + "\n" for ln in lines)
    return db


@pytest.mark.parametrize("seed", range(3))
def test_dbtools_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = random_db(rng), random_db(rng)
    tsv = "".join(f"{int(rng.integers(0, 9))}\tx{i}\ty\n" for i in range(30))
    assert dbt.tsv2db(tsv) == jax_dbt.tsv2db(tsv)
    for stat in ("linecount", "sum", "mean"):
        assert dbt.result2stats(a, stat) == jax_dbt.result2stats(a, stat)
    names = {k: f"g{k}" for k in a}
    for as_tsv in (False, True):
        for mapping in (None, names):
            assert (dbt.prefixid(a, as_tsv, mapping)
                    == jax_dbt.prefixid(a, as_tsv, mapping))
    for kw in (dict(trim_to_one_column=True), dict(extract_lines=2),
               dict(filter_column=5, filter_regex="^seq[1-4]$"),
               dict(filter_column=5, filter_regex="^seq[1-4]$",
                    positive_filter=False),
               dict(filter_expression="$2>=250&&$3<0.5"),
               dict(filter_expression="!($4<1e-10) || log($2+1)>5")):
        assert dbt.filterdb(a, **kw) == jax_dbt.filterdb(a, **kw)
    assert dbt.swapdb(a) == jax_dbt.swapdb(a)
    disjoint = {k + 100: v for k, v in b.items()}
    for keep in (True, False):
        assert (dbt.concatdbs(a, disjoint, keep)
                == jax_dbt.concatdbs(a, disjoint, keep))
    assert dbt.mergedbs([a, b]) == jax_dbt.mergedbs([a, b])
    for thr in (None, 1e-20):
        assert (dbt.subtractdbs(a, b, thr) == jax_dbt.subtractdbs(a, b, thr))
    keys = rng.integers(0, 40, 8).tolist()
    assert dbt.createsubdb(a, keys) == jax_dbt.createsubdb(a, keys)
    ren = {k: int(v) for k, v in zip(a, rng.permutation(100))}
    assert dbt.renamedbkeys(a, ren) == jax_dbt.renamedbkeys(a, ren)
    sets = {s: rng.integers(0, 40, 4).tolist() for s in range(5)}
    assert dbt.mergeresultsbyset(a, sets) == jax_dbt.mergeresultsbyset(a,
                                                                       sets)


EXPRESSIONS = ["$1>5", "$2*2-$3>=1", "!($1==$2)", "($1>3&&$2<4)||$3==0",
               "abs($1-$2)%3", "2^$1/($2+1)", "sqrt($1)+ln($2+1)",
               "floor($1)+ceil($2)+exp(0)", "pow($1,2)!=fmod($2,3)",
               "log10($1+1)<=1", "$1/0", "0/0", "$9"]


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_filter_expression_matches_jax(expr):
    rng = np.random.default_rng(len(expr))
    ours, theirs = FilterExpression(expr), JaxExpression(expr)
    assert ours.bindable_columns == theirs.bindable_columns

    def value(e, cols):
        """The value, or the error that a value outside a function's
        domain raises."""
        try:
            return e.evaluate(cols)
        except ValueError as err:
            return str(err)

    for _ in range(50):
        cols = [str(x) for x in rng.integers(-5, 20, 4)] + ["nan?", "1e3"]
        got, want = value(ours, cols), value(theirs, cols)
        assert got == want or (np.isnan(got) and np.isnan(want))
    for bad in ("__import__('os')", "$1.real", "open(1)"):
        with pytest.raises(ValueError):
            FilterExpression(bad)
        with pytest.raises(ValueError):
            JaxExpression(bad)
