"""Residue-balanced contiguous target splits.

Equivalent of the reference's DBReader::decomposeDomainByAminoAcid
(lib/mmseqs/src/commons/DBReader.cpp:1216-1260): split the key range
into `n` contiguous shards whose residue totals are as equal as the
greedy prefix walk allows.  Used for sequential out-of-core splits
bounded by a memory budget (Prefiltering.cpp:273-377,662-723), and for
the query splits of parallel/pipeline.py.
"""

from __future__ import annotations

import numpy as np


def residue_balanced_splits(lengths: np.ndarray, n: int
                            ) -> list[tuple[int, int]]:
    """Contiguous [start, end) key ranges with ~equal residue mass.

    Mirrors decomposeDomainByAminoAcid's proportional walk: shard i gets
    keys until its cumulative residue count reaches (i+1)/n of the
    total.  Every shard is non-empty when n <= len(lengths).
    """
    size = len(lengths)
    n = max(1, min(n, size))
    cum = np.concatenate(([0], np.cumsum(lengths.astype(np.int64))))
    total = int(cum[-1])
    bounds = [0]
    for i in range(1, n):
        cut = int(np.searchsorted(cum, total * i // n, side="left"))
        cut = max(cut, bounds[-1] + 1)          # non-empty shards
        cut = min(cut, size - (n - i))          # leave room for the rest
        bounds.append(cut)
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(n)]


def splits_for_memory_budget(lengths: np.ndarray, budget_bytes: int,
                             bytes_per_residue: int = 12
                             ) -> list[tuple[int, int]]:
    """Split count from an index-memory budget (the out-of-core analog of
    Prefiltering's memory model, Prefiltering.cpp:273-377): each target
    residue costs ~`bytes_per_residue` in the posting index (8 B posting
    + masked copy + slack); the dense k-mer offset tables are a fixed
    cost shared by all splits and excluded from the budget."""
    total = int(np.sum(lengths.astype(np.int64)))
    per_split = max(1, budget_bytes // bytes_per_residue)
    n = max(1, -(-total // per_split))
    return residue_balanced_splits(lengths, n)
