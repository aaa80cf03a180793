"""Faults planted in the program, to show that the comparison of
reference/judge.py catches them.  Only the tests and `control.py` plant
them; the benchmark's own runs never import this module.

  * unchanged: the search step returns and leaves no output (a step that
    returns its state unchanged);
  * half: half of the candidate pairs never reach the alignment (those
    whose query and target keys sum to an even number, in both
    directions);
  * altered: every alignment record's bit score is one higher than the
    engine computed (an answer altered where it is produced);
  * altered_hits: every hit line of the cluster TSV has its query start
    one higher than its record's (an answer altered where the tail
    writes it);
  * altered_traceback: every alignment record's identity is one residue
    higher than its traceback counted (one lower where all are
    identical): an answer altered where the traceback produces it;
  * not_best: the tail picks each query's hit in a genome from its
    records there with the best one left out (where it has two or more):
    a hit that is not the best.

A job on one card exchanges nothing between cards, so the fault of an
exchange left out has no place here.
"""

from __future__ import annotations

import contextlib

import numpy as np

def _drop_best(results: dict, set_ids) -> dict:
    """Each query's records with its best-E-value record in each target
    set left out, where the set holds two or more."""
    out = {}
    for qk, lines in results.items():
        groups: dict = {}
        for cols in lines:
            groups.setdefault(int(set_ids[int(cols[1])]), []).append(cols)
        drop = {id(min(g, key=lambda c: float(c[4])))
                for g in groups.values() if len(g) >= 2}
        out[qk] = [c for c in lines if id(c) not in drop]
    return out


def _keep_half(cands: dict) -> dict:
    return {qk: [t for t in ts if (qk + t) % 2] for qk, ts in cands.items()}


@contextlib.contextmanager
def planted(name: str):
    from spacedust_tpu_torch import cli
    from spacedust_tpu_torch.search import alignment as aln
    from spacedust_tpu_torch.workflow import clustersearch as cs
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "unchanged":
        patch(cli, "COMMANDS", dict(cli.COMMANDS,
                                    clustersearch=lambda argv: 0))
    elif name == "half":
        add, align_all = aln._AlignStream.add, aln.AlignmentEngine.align_all
        patch(aln._AlignStream, "add",
              lambda self, cands: add(self, _keep_half(cands)))
        patch(aln.AlignmentEngine, "align_all",
              lambda self, cands, *a, **k: align_all(
                  self, _keep_half(cands), *a, **k))
    elif name == "altered":
        finish = aln.AlignmentEngine._finish_pairs

        def altered(self, *a, **k):
            recs = finish(self, *a, **k)
            for r in recs:
                if r is not None:
                    r.score += 1
            return recs
        patch(aln.AlignmentEngine, "_finish_pairs", altered)
    elif name == "altered_hits":
        summarize = cs.summarize_results

        def shifted(*a, **k):
            out = []
            for line in summarize(*a, **k).splitlines(keepends=True):
                if line.startswith(">"):
                    cols = line.split("\t")
                    cols[5] = str(int(cols[5]) + 1)
                    line = "\t".join(cols)
                out.append(line)
            return "".join(out)
        patch(cs, "summarize_results", shifted)
    elif name == "altered_traceback":
        finish = aln.AlignmentEngine._finish_pairs

        def one_more(self, *a, **k):
            recs = finish(self, *a, **k)
            for r in recs:
                if r is not None:
                    n = len(r.backtrace)
                    ident = int(round(r.seq_id * n))
                    ident += 1 if ident < n else -1
                    r.seq_id = float(np.float32(ident) / np.float32(n))
            return recs
        patch(aln.AlignmentEngine, "_finish_pairs", one_more)
    elif name == "not_best":
        besthit = cs.besthit_by_set

        def second_best(results, target_db, *a, **k):
            return besthit(_drop_best(results, target_db.set_ids),
                           target_db, *a, **k)
        patch(cs, "besthit_by_set", second_best)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
