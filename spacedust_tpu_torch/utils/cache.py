"""On-disk artifact cache for derived tables (seed tables, k-mer indexes).

The reference rebuilds its ExtendedSubstitutionMatrix tables on every
process start (cheap in C++); here the sorted 3-mer product tables are a
64M-row sort, so they are persisted (the analog of the reference's
persisted prefilter index, PrefilteringIndexReader.cpp).

Cache root: $SPACEDUST_CACHE_DIR, else ~/.cache/spacedust_tpu_torch.
Artifacts are .npy files loadable with mmap (instant open, demand paging).
"""

from __future__ import annotations

import os
from pathlib import Path

CACHE_VERSION = 1


def cache_dir() -> Path:
    root = os.environ.get("SPACEDUST_CACHE_DIR")
    if root:
        p = Path(root)
    else:
        p = Path(os.path.expanduser("~")) / ".cache" / "spacedust_tpu_torch"
    p.mkdir(parents=True, exist_ok=True)
    return p


def artifact_path(name: str) -> Path:
    return cache_dir() / f"v{CACHE_VERSION}_{name}"
